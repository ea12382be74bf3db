"""The sweeps the window's lanes needed (each lane's reported matvecs plus
the entry's uncounted sweeps) over the lanes of A the GEMV kernel streamed
in the window (``LANES_SWEPT``), in %: the rest are lanes already done."""


def read(rec):
    swept = (rec.window.counters or {}).get("gemv_lanes_swept")
    if not swept or not rec.window.matvecs:
        return None
    needed = sum(int(m.sum()) + rec.uncounted_sweeps * m.shape[0] for m in rec.window.matvecs)
    return 100.0 * needed / swept
