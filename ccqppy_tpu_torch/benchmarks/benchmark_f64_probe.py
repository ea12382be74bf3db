"""f32 against f64 PCG on one card: what f64 costs, and where each floors.

Counterpart of the JAX package's ``benchmarks/benchmark_f64_probe.py``:
B=256 box QPs of n=256 (``A = G G^T + n I``), PCG from x = 0 with an
800-matvec budget, in f32 at tol 2e-5, then in f64 at tol 2e-5 and at tol
1e-9.  The ensemble is drawn once in f64 and rounded to f32 for the f32 row,
so all three rows solve the same problems (the JAX script draws each dtype
on its own).  Every timed rep perturbs b by 1e-3 N(0, 1).  The f32 row runs
the GEMV kernel's f32 instance, the f64 rows its f64 instance, at (256,
256).  Reports ``f64_over_f32_wall`` at tol 2e-5 and each row's
``sweep_cost_ms`` (the wall over the slowest lane's matvecs); each row adds
the f64 audit of its last rep (``true_residual_max``) to the JAX keys.

Run:  python -m ccqppy_tpu_torch.benchmarks.benchmark_f64_probe
      [--device cuda|cpu] [--out DIR] [-B 256] [-n 256]
Writes ``f64_probe.json``.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models import pcg
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.utils.benchmark import dense_sweep_bytes, timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

B, N = 256, 256
BUDGET = 800
REPS = 3
SEED = 0
PERTURB_TAG = 3
SWEEPS_FLOOR = 8   # least sweeps a call, for the timing guard
# (dtype, tol) of the rows, in the JAX script's order.
ROWS = ((torch.float32, 2e-5), (torch.float64, 2e-5), (torch.float64, 1e-9))


def run_pcg(As, b, proj, cfg):
    """PCG from x = 0 (the default start)."""
    return pcg.solve(As, b, proj=proj, config=cfg)


def run_row(As, bs, tol):
    """One row: 3 timed reps (after a warm-up) in the dtype of ``As``."""
    n = As.shape[-1]
    proj = box(-torch.ones(n), torch.ones(n), dtype=As.dtype, device=As.device)
    cfg = PCGConfig(tol=tol, max_matvecs=BUDGET)
    res = timed_run(lambda b: run_pcg(As, b, proj, cfg), reps=REPS,
                    make_args=lambda rep: (common.perturbed(bs, PERTURB_TAG, rep),),
                    implied_bytes=dense_sweep_bytes(As.shape[0], n, SWEEPS_FLOOR,
                                                    As.element_size()))
    r = res.result
    b_last = common.perturbed(bs, PERTURB_TAG, REPS - 1)
    mv_max = int(r.matvecs.max())
    return {
        "dtype": str(As.dtype).removeprefix("torch."), "tol": tol,
        "wall_s": res.wall_s,
        "solves_per_s": As.shape[0] / res.wall_s,
        "sweep_cost_ms": 1e3 * res.wall_s / max(mv_max, 1),
        "converged": float(r.converged.double().mean()),
        "matvecs_p50": common.p50(r.matvecs),
        "matvecs_max": mv_max,
        "residual_max": float(r.residual.max()),
        "residual_p50": common.p50(r.residual.double()),
        "true_residual_max": float(common.audit_residual(As, b_last, r.x,
                                                         common.f64_copy(proj)).max()),
    }


def main(B=B, n=N, device="cuda", out=common.DEFAULT_OUT):
    """The three rows; returns the JSON payload (also written to ``out``)."""
    device = common.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    As, bs, _ = random_qp_batch(gen, B, n, torch.float64, diag_boost=1.0)
    rows = [run_row(As.to(dtype), bs.to(dtype), tol) for dtype, tol in ROWS]
    payload = {"backend": device.type,
               "workload": f"B={B} n={n} box QPs (diag_boost=1 Wishart, drawn in f64, rounded "
                           f"to f32 for the f32 row), PCG, x0 = 0",
               "f64_over_f32_wall": rows[1]["wall_s"] / rows[0]["wall_s"],
               "rows": rows, "card": common.card_stamp(device)}
    for row in rows:
        print(row)
    print(f"f64/f32 wall ratio at tol 2e-5: {payload['f64_over_f32_wall']:.4f}")
    common.write_json(out, "f64_probe.json", payload)
    return payload


def cli(argv=None):
    ap = common.parser("f32 against f64 PCG on one card.")
    ap.add_argument("-B", type=int, default=B)
    ap.add_argument("-n", type=int, default=N)
    a = ap.parse_args(argv)
    return main(a.B, a.n, a.device, a.out)


if __name__ == "__main__":
    cli()
