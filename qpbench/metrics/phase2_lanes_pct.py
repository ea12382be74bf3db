"""The share of the window's lanes whose matvecs exceed the mix's phase-1
budget (the lanes compaction re-solved), in %; none for a mix without
compaction."""
import numpy as np


def read(rec):
    if "phase1" not in rec.mix or not rec.window.matvecs:
        return None
    mv = np.concatenate(rec.window.matvecs)
    return 100.0 * float((mv > int(rec.mix["phase1"])).mean())
