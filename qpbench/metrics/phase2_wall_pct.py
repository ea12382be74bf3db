"""The union of the program's ``ccqppy.phase2`` spans (straggler
compaction after phase 1) and of its ``ccqppy.gather`` spans from the
moment their read of the unconverged lanes returns, over the sum of the
profiled calls' walls, in %; none for a mix without compaction.

A gather span opens with that read (``lane_indices``), which waits for
phase 1's queued kernels: phase 1's time.  The device idles from the
moment the read returns until the host launches the gather's copies, so
the read returns where the first idle interval that starts inside the
span starts; a span in which none starts counts whole."""
import bisect

from qpbench import trace


def read(rec):
    t = rec.trace
    if "phase1" not in rec.mix or t is None or "ccqppy.solve" not in t.spans \
            or not rec.profiled.walls:
        return None
    starts = [s for s, _ in t.idle]
    own = []
    for s, e in t.spans.get("ccqppy.gather", []):
        i = bisect.bisect_right(starts, s)
        own.append([starts[i] if i < len(starts) and starts[i] < e else s, e])
    phase2 = trace.merged(own + t.spans.get("ccqppy.phase2", []))
    return 100.0 * sum(e - s for s, e in phase2) / sum(rec.profiled.walls)
