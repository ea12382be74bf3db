"""Ill-conditioned ensembles: plain f32 PCG against rr-PCG on bf16 sweeps.

Counterpart of the JAX package's ``benchmarks/benchmark_illcond.py``, with
its argparse defaults.  For each ``diag_boost`` in {0.1, 0.05, 0.02} (cond
~ 41 / 81 / 201): B=1024 box QPs of n=1000, ``A = G G^T + boost n I``, from
the Jacobi start of the unperturbed b, tol 2e-5, a 2000-matvec budget.
Plain PCG on the f32 stack against residual-replacement PCG on ``MixedPrecDense(A, A_bf16)``
(the bf16 copy from ``prepare_dense_batch``; the cheap sweeps are the GEMV
kernel's bf16 instance, the refreshes its f32 one) at each ``refresh_every``
of ``--refresh``, with ``segment_drop = min(0.5, 4e-3 (4 + boost) / boost)``
as the JAX script sets it.  Every timed rep perturbs b by 1e-3 N(0, 1);
both sides' last reps are audited in f64 (plain GEMV, never the kernel).
A family's stacks are freed before the next is drawn.

Run:  python -m ccqppy_tpu_torch.benchmarks.benchmark_illcond [--device cuda|cpu]
      [--out DIR] [-n 1000] [-B 1024] [--tol 2e-5] [--budget 2000] [--reps 3]
      [--boosts 0.1 0.05 0.02] [--refresh 16 32]
Writes ``illcond.json``.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models import pcg
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.linop import MixedPrecDense
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import prepare_dense_batch
from ccqppy_tpu_torch.utils.benchmark import dense_sweep_bytes, timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

N = 1000
B = 1024
TOL = 2e-5
BUDGET = 2000
REPS = 3
BOOSTS = (0.1, 0.05, 0.02)
REFRESH = (16, 32)
SEED = 0
PERTURB_TAG = 5
SWEEPS_FLOOR = 20  # least f32 sweeps a call, for the timing guard


def segment_drop(boost):
    """~ eps_bf16 x the condition estimate: a segment stops once it has
    cashed what bf16 precision can pay a cycle."""
    return min(0.5, 4e-3 * (4.0 + boost) / max(boost, 1e-3))


def run_plain(As, b, x0, proj, cfg):
    """Plain PCG on the f32 stack."""
    return pcg.solve(As, b, x0=x0, proj=proj, config=cfg)


def run_rr(As, As16, b, x0, proj, cfg):
    """rr-PCG on ``MixedPrecDense(As, As16)``."""
    return pcg.solve(MixedPrecDense(As, As16), b, x0=x0, proj=proj, config=cfg)


def main(n=N, B=B, tol=TOL, budget=BUDGET, reps=REPS, boosts=BOOSTS, refresh=REFRESH,
         device="cuda", out=common.DEFAULT_OUT):
    """Every family's rows; returns the JSON payload (also written to ``out``)."""
    device = common.resolve_device(device)
    proj = box(-torch.ones(n), torch.ones(n), device=device)
    proj64 = common.f64_copy(proj)

    def timed(run, As, bs):
        res = timed_run(run, reps=reps,
                        make_args=lambda rep: (common.perturbed(bs, PERTURB_TAG, rep),),
                        implied_bytes=dense_sweep_bytes(B, n, SWEEPS_FLOOR))
        b_last = common.perturbed(bs, PERTURB_TAG, reps - 1)
        r = res.result
        return res.wall_s, {
            "wall_s": res.wall_s,
            "solves_per_s": B / res.wall_s,
            "converged": float(r.converged.double().mean()),
            "matvecs_p50": common.p50(r.matvecs),
            "matvecs_max": int(r.matvecs.max()),
            "true_res_max": float(common.audit_residual(As, b_last, r.x, proj64).max()),
        }

    rows = []
    for boost in boosts:
        gen = torch.Generator(device=device).manual_seed(SEED)
        As, bs, _ = random_qp_batch(gen, B, n, torch.float32, diag_boost=float(boost), chunk=256)
        As, As16 = prepare_dense_batch(As, torch.bfloat16)
        # The Jacobi start of the unperturbed b, for every rep, as in the JAX script.
        x0 = torch.clamp(-bs / As.diagonal(dim1=-2, dim2=-1), -1.0, 1.0)

        cfg = PCGConfig(tol=tol, max_matvecs=budget)
        wall_p, plain = timed(lambda b: run_plain(As, b, x0, proj, cfg), As, bs)
        row = {"diag_boost": boost, "n": n, "B": B, "tol": tol, "plain_f32": plain, "rr": []}
        for K in refresh:
            drop = segment_drop(boost)
            cfg_rr = PCGConfig(tol=tol, max_matvecs=budget, refresh_every=int(K),
                               segment_drop=float(drop))
            wall_r, rr = timed(lambda b: run_rr(As, As16, b, x0, proj, cfg_rr), As, bs)
            row["rr"].append({"refresh_every": int(K), "segment_drop": drop, **rr,
                              "speedup_vs_plain": wall_p / wall_r})
        rows.append(row)
        print(row, flush=True)
        del As, As16, bs, x0
        if device.type == "cuda":
            torch.cuda.empty_cache()

    payload = {"backend": device.type,
               "workload": f"B={B} n={n} box QPs, A = G G^T + boost*n*I, tol {tol:g}, jacobi "
                           f"x0, PCG plain-f32 vs rr-PCG (MixedPrecDense bf16 sweeps)",
               "rows": rows, "card": common.card_stamp(device)}
    common.write_json(out, "illcond.json", payload)
    return payload


def cli(argv=None):
    ap = common.parser("Ill-conditioned ensembles: plain f32 PCG against rr-PCG on one card.")
    ap.add_argument("-n", type=int, default=N)
    ap.add_argument("-B", type=int, default=B)
    ap.add_argument("--tol", type=float, default=TOL)
    ap.add_argument("--budget", type=int, default=BUDGET)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--boosts", type=float, nargs="+", default=list(BOOSTS))
    ap.add_argument("--refresh", type=int, nargs="+", default=list(REFRESH))
    a = ap.parse_args(argv)
    return main(a.n, a.B, a.tol, a.budget, a.reps, a.boosts, a.refresh, a.device, a.out)


if __name__ == "__main__":
    cli()
