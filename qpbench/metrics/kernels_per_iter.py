"""Device kernels (not copies or fills) launched in the profiled calls, over
those calls' gain of the program's MPRGP iteration counter
(``mprgp_iters``); none where the entry does not count MPRGP iterations."""


def read(rec):
    iters = None if rec.profiled is None else (rec.profiled.counters or {}).get("mprgp_iters")
    if rec.trace is None or not iters:
        return None
    return rec.trace.kernels / iters
