"""The least time of the profiled calls' counted sweeps (``counts``: each
input byte read once, each output written once, 2 FLOPs an element of A)
over the device time of the GEMV kernels in those calls, in %."""
from qpbench import counts


def read(rec):
    peak = counts.peaks(rec.device_kind)
    t = rec.trace
    if peak is None or t is None or t.gemv_s <= 0 or rec.profiled is None:
        return None
    sweeps = sum(int(m.sum()) + rec.uncounted_sweeps * m.shape[0] for m in rec.profiled.matvecs)
    least, _ = counts.least_seconds(int(rec.config["n"]), sweeps, rec.config["dtype"], peak)
    return 100.0 * least / t.gemv_s
