"""1 - the union of device operations' intervals over the profiled calls'
window, in %."""


def read(rec):
    return None if rec.trace is None else 100.0 * rec.trace.idle_share
