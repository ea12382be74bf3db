"""The device's idle time inside the program's ``ccqppy.solve`` spans of
the profiled calls (their union's exact overlap with the idle intervals)
over the traced window, in %; the rest of ``device_idle_pct`` is the
caller's (draw, start point, fetch)."""
from qpbench import trace


def read(rec):
    solves = None if rec.trace is None else rec.trace.spans.get("ccqppy.solve")
    if not solves:
        return None
    return 100.0 * trace.overlap(rec.trace.idle, solves) / rec.trace.window_s
