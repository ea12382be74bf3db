"""The program's host reads of a device value (``HOST_SYNCS``: each solver
loop's test and compaction's ``nonzero``) over the window, per call."""


def read(rec):
    syncs = (rec.window.counters or {}).get("host_syncs")
    if syncs is None or not rec.window.walls:
        return None
    return syncs / len(rec.window.walls)
