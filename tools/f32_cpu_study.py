#!/usr/bin/env python3
"""The new solvers of ccqppy_tpu_torch in f32 at full width, on the CPU.

Runs the port's plain (CPU) path at the widths the card runs them, on fewer
lanes: classic APGD on the box ensemble (n=1000, [-1, 1], Jacobi start,
5000 matvecs) at tol 2e-5 and 1e-4, APGD-AR and SPG on the cone ensemble
(n=999, 333 Lorentz blocks, tol 1e-5, 2000 matvecs), each lane audited in
f64; and, for APGD, the band its residual bounces in once it stops
descending (from iteration 100 on, in a run at tol 1e-13).  The numbers are CPU
arithmetic in f32, not device measurements; ``chip_smoke.py`` times the
same modes on the card.

Run:  python3 tools/f32_cpu_study.py [--lanes 48] [--seed 0] [--threads 4]
"""
import argparse
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ccqppy_tpu_torch.models import apgd, spg  # noqa: E402
from ccqppy_tpu_torch.models.base import pg_residual  # noqa: E402
from ccqppy_tpu_torch.ops.projections import blockwise, box, lorentz_cone  # noqa: E402
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch  # noqa: E402
from ccqppy_tpu_torch.utils.rng import split_keys  # noqa: E402


def audit(A, b, x, proj64, chunk=16):
    """Each lane's Eq. 25 residual in f64, in lane chunks."""
    return torch.cat([
        pg_residual(proj64, x[i:i + chunk].double(),
                    torch.einsum("bij,bj->bi", A[i:i + chunk].double(), x[i:i + chunk].double())
                    + b[i:i + chunk].double(), 1e-6)
        for i in range(0, x.shape[0], chunk)])


def report(name, r, res, t0):
    mv = r.matvecs.float()
    print(f"{name}: converged {float(r.converged.float().mean()):.4f}, matvecs p50 "
          f"{float(mv.median()):.0f} p90 {float(mv.quantile(0.9)):.0f} max {int(mv.max())}, "
          f"audited max {float(res.max()):.4e}, reported max {float(r.residual.max()):.4e}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    B = args.lanes

    gen = torch.Generator().manual_seed(args.seed)
    A, b, _ = random_qp_batch(gen, B, 1000, torch.float32, diag_boost=1.0, chunk=8)
    proj = box(-torch.ones(1000), torch.ones(1000))
    box64 = box(-torch.ones(1000), torch.ones(1000), dtype=torch.float64)
    x0 = torch.clamp(-b / A.diagonal(dim1=-2, dim2=-1), -1, 1)
    for tol in (2e-5, 1e-4):
        t0 = time.perf_counter()
        r = apgd.solve(A, b, x0=x0, proj=proj, config=apgd.APGDConfig(tol=tol, max_matvecs=5000))
        report(f"box apgd, tol {tol:g}, {B} lanes", r, audit(A, b, r.x, box64), t0)
    r = apgd.solve(A[:8], b[:8], x0=x0[:8], proj=proj,
                   config=apgd.APGDConfig(tol=1e-13, max_matvecs=2000, trace_len=1000))
    late = r.trace[:, 100:]
    seen = late.isfinite().sum(dim=1)

    def share(t):
        return [round(v, 3) for v in ((late < t).sum(dim=1) / seen).tolist()]

    print("box apgd band, 8 lanes, from iteration 100 on: median residual per lane "
          f"{[f'{v:.2e}' for v in late.nanmedian(dim=1).values.tolist()]}; share below 2e-5 "
          f"{share(2e-5)}; below 1e-4 {share(1e-4)}", flush=True)
    del A, b, x0, r

    gen = torch.Generator().manual_seed(args.seed + 1)
    A, b, _ = random_qp_batch(gen, B, 999, torch.float32, diag_boost=1.0, chunk=8)
    cone = blockwise(lorentz_cone(1.0), 3)
    cone64 = blockwise(lorentz_cone(1.0, dtype=torch.float64), 3)
    x0 = cone.project(-b / A.diagonal(dim1=-2, dim2=-1))
    t0 = time.perf_counter()
    r = apgd.solve_anti_relaxation(A, b, x0=x0, proj=cone,
                                   config=apgd.APGDConfig(tol=1e-5, max_matvecs=2000))
    report(f"cone apgd_ar, {B} lanes", r, audit(A, b, r.x, cone64), t0)
    t0 = time.perf_counter()
    r = spg.solve(A, b, proj=cone, config=spg.SPGConfig(tol=1e-5, max_matvecs=2000),
                  keys=split_keys(1, B))
    report(f"cone spg, {B} lanes", r, audit(A, b, r.x, cone64), t0)
    mv = r.matvecs.float()
    print(f"cone spg: share of lanes above twice the p50 ({2 * int(mv.median())}): "
          f"{float((mv > 2 * mv.median().floor()).float().mean()):.4f}")


if __name__ == "__main__":
    main()
