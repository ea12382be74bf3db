"""Run a cell several times, one process a run, and report each metric's
spread: the distance between the first and third quartile as
``statistics.quantiles(values, n=4)`` gives them, as a share of the median.

    python3 qpbench/spread.py --workload <cell> --seeds 11 12 13 --seconds 20 \
        [--trace 0|1] [--sets 2] [--out results.json]

The runs go one after another (one process on the card at a time); with
``--sets 2`` the seeds run twice, as two sets.  Each run's result line, its
last lines of standard error, its exit code and its process wall are kept
in ``--out``; a summary per set is printed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    """(median, q1, q3, (q3 - q1) / median); None with fewer than 2 values."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3,
            "spread": (q3 - q1) / statistics.median(values)}


def run_once(workload, seed, seconds, trace):
    cmd = [sys.executable, str(ROOT / "qpbench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": p.returncode, "process_s": wall, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def summary(runs):
    metrics = {}
    for r in runs:
        for name, m in ((r["result"] or {}).get("metrics") or {}).items():
            metrics.setdefault(name, []).append(m["value"])
    return {name: {"values": v, **(spread(v) or {})} for name, v in metrics.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"workload": a.workload, "seconds": a.seconds, "trace": a.trace, "card": smi, "sets": []}
    for s in range(a.sets):
        runs = [run_once(a.workload, seed, a.seconds, a.trace) for seed in a.seeds]
        out["sets"].append({"runs": runs, "summary": summary(runs)})
        print(f"set {s}: rc {[r['rc'] for r in runs]}, correct "
              f"{[(r['result'] or {}).get('correct') for r in runs]}, process s "
              f"{[round(r['process_s'], 1) for r in runs]}", flush=True)
        for name, m in out["sets"][-1]["summary"].items():
            print(f"  {name}: median {m.get('median')} spread {m.get('spread')} "
                  f"values {m['values']}", flush=True)
        for r in runs:
            if r["rc"] != 0 or not (r["result"] or {}).get("correct"):
                print(f"  seed {r['seed']} rc {r['rc']}:\n{r['stderr_tail'][-1500:]}", flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
