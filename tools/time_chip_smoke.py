#!/usr/bin/env python3
"""Time ``chip_smoke.py`` of several trees in one call, line by line.

Each TREE is a checkout (for example an older commit unpacked with ``git
archive`` into the gitignored ``.scratch/``).  The script runs ``python3 -u
chip_smoke.py`` from each TREE in the order given -- name a tree twice to
interleave, as in ``OLD NEW NEW OLD`` -- stamps every line the run prints
(standard output and errors together) with the seconds since the run
started, and writes each stamped log to
``chiprun_out/time_chip_smoke/run<i>.log``.  It then prints, for each run,
its exit code, its command wall (interpreter start and imports included)
and the second of its first line; and a table of the segments between
lines that every run printed, keyed by the line's text up to its first
``:`` (else its first four words) with every number read as ``#``, with
each run's seconds.  A segment
whose runs spread by more than ``SPREAD_S`` is marked ``*``.

Run:  python3 tools/time_chip_smoke.py TREE [TREE ...]     (one CUDA GPU)
"""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "time_chip_smoke"
SPREAD_S = 1.0


def key(line):
    head, sep, _ = line.partition(":")
    head = head.strip() if sep and len(head) <= 60 else " ".join(line.split()[:4])
    return re.sub(r"\d+(\.\d+)?(e[+-]?\d+)?", "#", head)


def run(tree, log_path):
    """(exit code, command wall s, [(second, line)]) of one run."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=tree, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    with open(log_path, "w") as log:
        for line in proc.stdout:
            t = time.monotonic() - t0
            lines.append((t, line.rstrip("\n")))
            log.write(f"{t:9.3f} {line}")
    rc = proc.wait()
    return rc, time.monotonic() - t0, lines


def segments(runs):
    """The keys every run printed, in the first run's order, kept only where
    they come later than the previous kept key in every run."""
    firsts = []
    for _, _, lines in runs:
        seen = {}
        for t, line in lines:
            if line.strip():
                seen.setdefault(key(line), t)
        firsts.append(seen)
    kept, last = [], [0.0] * len(runs)
    for k in firsts[0]:
        ts = [f.get(k) for f in firsts]
        if all(t is not None and t >= prev for t, prev in zip(ts, last)):
            kept.append((k, [t - prev for t, prev in zip(ts, last)]))
            last = ts
    return kept


def main(trees):
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(trees):
        rc, wall, lines = run(tree, OUT / f"run{i}.log")
        first = lines[0][0] if lines else float("nan")
        print(f"run{i} {tree}: exit {rc}, command wall {wall:.3f} s, first line at {first:.3f} s, "
              f"last line: {lines[-1][1] if lines else ''}", flush=True)
        runs.append((rc, wall, lines))
    print("segment (seconds since the previous row) | " +
          " | ".join(f"run{i}" for i in range(len(runs))))
    for k, dts in segments(runs):
        mark = "*" if max(dts) - min(dts) > SPREAD_S else " "
        print(f"{mark} {k[:70]:70s} " + " ".join(f"{dt:8.3f}" for dt in dts))
    print("command wall " + " ".join(f"{w:.3f}" for _, w, _ in runs))
    return max(rc != 0 for rc, _, _ in runs)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
