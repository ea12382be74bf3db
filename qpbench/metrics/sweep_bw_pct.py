"""The bytes of A the window's lanes needed (each lane's reported matvecs
plus the path's uncounted sweeps, ``counts.sweep_bytes``) over the window's
seconds, as a share of the card's published HBM rate, in %."""
from qpbench import counts


def read(rec):
    peak = counts.peaks(rec.device_kind)
    if peak is None or not rec.window.matvecs:
        return None
    sweeps = sum(int(m.sum()) + rec.uncounted_sweeps * m.shape[0] for m in rec.window.matvecs)
    n, dtype = int(rec.config["n"]), rec.config["dtype"]
    rate = counts.sweep_bytes(n, sweeps, dtype) / rec.window.window_s
    return 100.0 * rate / peak["hbm_bytes_per_s"]
