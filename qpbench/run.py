"""Run one cell of the benchmark once on the card and print its result line.

    python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number the
check compared with its limit); the last lines of standard error repeat the
compared numbers.  Without a CUDA device, or with fewer than the cell asks
for, the run prints no result and exits with 2; it never falls back to the
CPU.  A module of JAX or of the JAX package loaded in the process exits
with 3, an error with 1.
"""
import time

T0 = time.perf_counter()   # set-up counts from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: The checkout's root.
ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # The bytecode of every module the run imports (torch's too) is kept at
    # a fixed path inside the checkout, so that only a checkout's first run
    # compiles it, also where the environment forbids writing bytecode
    # beside the sources.
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    if __package__ in (None, ""):
        # Run as a file: import the benchmark as a package from the checkout.
        sys.path[0] = str(ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from qpbench import harness
    from qpbench.registry import Registry
    imported = time.perf_counter()

    reg = Registry()
    chips = int(reg.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    try:
        result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                         bool(args.trace), registry=reg, t0=T0,
                                         imported=imported)
    except harness.ForbiddenImport as e:
        print(f"forbidden import: {e}", file=sys.stderr)
        return 3
    harness.emit(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
