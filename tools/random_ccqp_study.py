#!/usr/bin/env python3
"""The reference random-ensemble study of ``benchmarks/benchmark_random_ccqp.py``
through the port, on the card.

Both halves at the study's own parameters: 64 trials a cell, tol 1e-5, a
5000-matvec budget, diag_boost 1, f32,

* single: pgd, apgd, apgd_ar, bbpgd, bbpgd_f, spg, pcg over the five
  single-constraint families (``default_families``) at n = 8, 32, 128, 512;
* disjoint: apgd_ar, bbpgd, bbpgd_f, spg, mprgp, mprgp_bb, pcg over the five
  3-block families (``disjoint_families``) at n = 9, 33, 129, 513.

Each (solver, family, size) cell is one ``solve_batched`` over its trials,
timed by ``timed_run`` (a warm call, then the min of two).  Every cell's
line (convergence, mean matvecs, solves/s) is printed as it finishes, then
each half's summary and the half's wall.  Every half writes its JSON
(``BenchmarkResult.to_json``) to OUT/<half>.json, and its three PNGs
(``process_results``) where matplotlib is installed; the script says which.

Run:  python3 tools/random_ccqp_study.py [single|disjoint|both] [--out DIR]
      (needs one CUDA GPU, nvcc for sm_90a; minutes; OUT defaults to
      build/random_ccqp_study, which git ignores)
"""
import argparse
import importlib.util
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccqppy_tpu_torch.ops import gemv, kernels  # noqa: E402
from ccqppy_tpu_torch.utils.benchmark import (BenchmarkRandomCCQP,  # noqa: E402
                                              default_families, disjoint_families)

TRIALS, TOL, BUDGET, DIAG_BOOST = 64, 1e-5, 5000, 1.0
HALVES = {
    "single": (["pgd", "apgd", "apgd_ar", "bbpgd", "bbpgd_f", "spg", "pcg"],
               default_families, [8, 32, 128, 512]),
    "disjoint": (["apgd_ar", "bbpgd", "bbpgd_f", "spg", "mprgp", "mprgp_bb", "pcg"],
                 lambda dtype, device: disjoint_families(3, dtype, device), [9, 33, 129, 513]),
}


def run_half(name, out, dev):
    solvers, families, sizes = HALVES[name]
    bench = BenchmarkRandomCCQP(TRIALS, solvers, families(torch.float32, dev), sizes, tol=TOL,
                                max_matvecs=BUDGET, dtype=torch.float32, diag_boost=DIAG_BOOST,
                                device=dev)
    t0 = time.perf_counter()
    result = bench.run()
    wall = time.perf_counter() - t0
    path = out / f"{name}.json"
    result.to_json(path)
    print(result.summary())
    print(f"{name}: {len(solvers) * len(sizes) * 5} cells in {wall:.1f} s; JSON {path}")
    if importlib.util.find_spec("matplotlib") is None:
        print(f"{name}: matplotlib is not installed: no PNGs")
    else:
        bench.process_results(save_prefix=str(out / name))
        print(f"{name}: PNGs {out / name}_{{solve_time,matvecs,residual}}.png")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="both", choices=["single", "disjoint", "both"])
    parser.add_argument("--out", type=pathlib.Path,
                        default=ROOT / "build" / "random_ccqp_study")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    kernels.load()
    args.out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    for name in (["single", "disjoint"] if args.which == "both" else [args.which]):
        before = gemv.LAUNCHES
        run_half(name, args.out, dev)
        print(f"{name}: GEMV launches {gemv.LAUNCHES - before}", flush=True)


if __name__ == "__main__":
    main()
