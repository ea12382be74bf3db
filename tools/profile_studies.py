#!/usr/bin/env python3
"""Where the time of one call goes in two host-bound studies of
``ccqppy_tpu_torch/benchmarks/``: the large cone's MPRGP-BB call (one QP,
n=9999) and one warm-started step of the warm-start study (B=512, n=1000).

Same draws as the studies (seeds, widths, the first step of rep 0's walk,
the warm step started from the cold solution of that step's previous
right-hand side).  Each call runs once to warm up, then once under
``torch.profiler``; ``tools/profile_modes.py``'s ``profiled`` prints the
wall, the device busy time, the idle share and the kernels an iteration.
The profiler adds host time, so its walls are longer than the studies'.

Run:  python3 tools/profile_studies.py      (needs one CUDA GPU, nvcc for sm_90a)
"""
import importlib.util
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccqppy_tpu_torch.benchmarks import (benchmark_large_cone as lc,  # noqa: E402
                                         benchmark_warmstart_sequence as ws, common)
from ccqppy_tpu_torch.models import pcg  # noqa: E402
from ccqppy_tpu_torch.models.pcg import PCGConfig  # noqa: E402
from ccqppy_tpu_torch.ops.projections import blockwise, box, lorentz_cone  # noqa: E402
from ccqppy_tpu_torch.utils.random_qp import random_qp, random_qp_batch  # noqa: E402


def load_profiled():
    spec = importlib.util.spec_from_file_location("profile_modes", ROOT / "tools" / "profile_modes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.profiled


def main():
    dev = common.resolve_device("cuda")
    print(common.card_stamp(dev))
    profiled = load_profiled()

    def max_iterations(r):
        return int(r.iterations.max())

    gen = torch.Generator(device=dev).manual_seed(lc.SEED)
    A, b, _ = random_qp(gen, lc.N, torch.float32, diag_boost=1.0)
    proj = blockwise(lorentz_cone(lc.MU, device=dev), 3)
    profiled(f"large cone mprgp_bb (B=1, n={lc.N})",
             lambda: lc.run_solver("mprgp_bb", A, b, proj), max_iterations)
    del A, b
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(ws.SEED)
    As, bs, _ = random_qp_batch(gen, ws.B, ws.N, torch.float32, diag_boost=1.0)
    proj = box(-torch.ones(ws.N), torch.ones(ws.N), device=dev)
    cfg = PCGConfig(tol=ws.TOL, max_matvecs=ws.BUDGET)
    b1 = bs + next(ws.walk(bs, ws.DRIFT * float(bs.abs().mean()), 1, 0))
    x_prev = pcg.solve(As, bs, proj=proj, config=cfg).x
    profiled(f"warm start, one warm step (B={ws.B}, n={ws.N})",
             lambda: pcg.solve(As, b1, x0=x_prev, proj=proj, config=cfg), max_iterations)
    profiled(f"warm start, the same step cold (B={ws.B}, n={ws.N})",
             lambda: pcg.solve(As, b1, x0=torch.zeros_like(b1), proj=proj, config=cfg),
             max_iterations)


if __name__ == "__main__":
    main()
