"""Device time of every kernel other than the GEMV in the profiled calls,
per call, in ms."""


def read(rec):
    if rec.trace is None or not rec.profiled.walls:
        return None
    return 1e3 * rec.trace.other_kernel_s / len(rec.profiled.walls)
