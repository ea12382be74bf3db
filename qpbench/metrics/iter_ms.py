"""Host time of one MPRGP loop iteration: the window's call seconds over its
gain of the program's iteration counter (``mprgp_iters``), in ms; none
where the entry does not count MPRGP iterations."""


def read(rec):
    iters = (rec.window.counters or {}).get("mprgp_iters")
    if not iters or not rec.window.walls:
        return None
    return 1e3 * sum(rec.window.walls) / iters
