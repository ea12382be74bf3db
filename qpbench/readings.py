"""The readings a cell's limits are set from, in one process on the card.

    python3 qpbench/readings.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 --seconds 6 [--out readings.json]

For each seed of ``--seeds`` a run of the program (a short window at the
cell's own load and sizes, the same check as a run's); for each of
``--control-seeds`` the same (for ``--control-seconds``) with the TF32 control
(``reference/control.py``) in the program's place.  Prints, for every
compared number, the largest the program read (the lower reading) and the
smallest the control read (the upper reading).  The benchmark's own runs
never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seconds", type=float)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args(argv)
    import torch

    from qpbench import harness
    from qpbench.reference import control

    if not torch.cuda.is_available():
        raise SystemExit("readings are taken on the card")
    runs = []
    for kind, seeds, entry, seconds in (
            ("program", a.seeds, None, a.seconds),
            ("control", a.control_seeds, control, a.control_seconds or a.seconds)):
        for seed in seeds:
            result, lines = harness.run_cell(a.workload, seed, seconds, False, entry=entry)
            runs.append({"kind": kind, "seed": seed, "correct": result["correct"],
                         "attempted": result["attempted"], "failed": result["failed"],
                         "checks": result["checks"], "lines": lines})
            print(kind, seed, result["correct"], *lines, sep="\n  ", flush=True)
    summary = {}
    for kind, pick in (("program", max), ("control", min)):
        for r in (r for r in runs if r["kind"] == kind):
            for name, c in r["checks"].items():
                s = summary.setdefault(name, {})
                s[kind] = c["value"] if kind not in s else pick(s[kind], c["value"])
    print(json.dumps({"workload": a.workload, "summary": summary}), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"workload": a.workload, "seconds": a.seconds,
                                     "runs": runs, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
