"""Device kernels (not copies or fills) launched in the profiled calls, per
call."""


def read(rec):
    if rec.trace is None or not rec.profiled.walls:
        return None
    return rec.trace.kernels / len(rec.profiled.walls)
