"""One dense cone QP at n=9999: MPRGP-BB against SPG, BBPGDf and PCG.

Counterpart of the JAX package's ``benchmarks/benchmark_large_cone.py``
(BASELINE.json config #3): one QP of n = 9999 (``A = G G^T + n I``, 400 MB
in f32, ``b = -A x_uncon``) under 3333 Lorentz cones of dimension 3
(``blockwise(lorentz_cone(mu), 3)``, mu = 1), solved as a batch of one
(the port's solvers are batched) by ``mprgp_bb``, ``spg``, ``bbpgd_f`` and
``pcg`` at tol 1e-5 with a 20,000-matvec budget.  ``pcg`` delegates to fused
MPRGP-BB on a set that is not polyhedral, as in the JAX package, so its row
repeats ``mprgp_bb``'s.  SPG's keys are ``split_keys(seed + 1, 1)``, as the
harness draws them.

Each solver runs 3 timed reps (after a warm-up) on the same three
right-hand sides, b plus 1e-4 N(0, 1): absolute, as the JAX script adds it,
so below the f32 ulp of most of b's entries (|b| ~ 1e4).  Each row keeps
the JAX keys: ``true_residual`` is the f64 audit of the last rep (an f64
copy of A, 800 MB), ``feasibility_gap`` is ``|x - proj(x)|``.  At B=1 the
wall is the host's: a few hundred small kernels an iteration around one
GEMV of 400 MB (0.12 ms at the card's memory rate).

Run:  python -m ccqppy_tpu_torch.benchmarks.benchmark_large_cone
      [--device cuda|cpu] [--out DIR] [-n 9999] [--mu 1.0]
Writes ``large_cone.json``.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.ops.projections import blockwise, lorentz_cone
from ccqppy_tpu_torch.utils.benchmark import timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp
from ccqppy_tpu_torch.utils.rng import split_keys

N = 9999
MU = 1.0
SOLVER_NAMES = ("mprgp_bb", "spg", "bbpgd_f", "pcg")
TOL = 1e-5
BUDGET = 20_000
REPS = 3
SEED = 0
NOISE = 1e-4
PERTURB_TAG = 9
SWEEPS_FLOOR = 8   # least sweeps of a call, for the timing guard


def run_solver(name, A, b, proj, seed=SEED):
    """One call of solver ``name`` (SPG on the keys ``split_keys(seed + 1, 1)``)."""
    fn, cfg_cls = SOLVERS[name]
    kwargs = {"keys": split_keys(seed + 1, b.shape[0], b.device)} if name == "spg" else {}
    return fn(A, b, proj=proj, config=cfg_cls(tol=TOL, max_matvecs=BUDGET), **kwargs)


def main(n=N, mu=MU, seed=SEED, device="cuda", dtype=torch.float32, out=common.DEFAULT_OUT):
    """Every solver's row; returns the JSON payload (also written to ``out``)."""
    device = common.resolve_device(device)
    n = int(n) // 3 * 3
    gen = torch.Generator(device=device).manual_seed(int(seed))
    A, b, _ = random_qp(gen, n, dtype, diag_boost=1.0)
    proj = blockwise(lorentz_cone(float(mu), dtype, device), 3)
    proj64 = common.f64_copy(proj)

    rows = []
    for name in SOLVER_NAMES:
        res = timed_run(lambda b_, s=name: run_solver(s, A, b_, proj, seed), reps=REPS,
                        make_args=lambda rep: (common.perturbed(b, PERTURB_TAG, rep, NOISE),),
                        implied_bytes=float(n) * n * A.element_size() * SWEEPS_FLOOR)
        r = res.result
        b_rep = common.perturbed(b, PERTURB_TAG, REPS - 1, NOISE)
        row = {
            "solver": name,
            "converged": bool(r.converged[0]),
            "matvecs": int(r.matvecs[0]),
            "residual": float(r.residual[0]),
            "true_residual": float(common.audit_residual(A, b_rep, r.x, proj64)[0]),
            "feasibility_gap": float(torch.linalg.vector_norm(r.x[0] - proj.project(r.x)[0])),
            "wall_s": res.wall_s,
            "iters_per_s": int(r.iterations[0]) / res.wall_s,
        }
        rows.append(row)
        print(row, flush=True)

    payload = {"n": n, "mu": float(mu), "tol": TOL, "budget": BUDGET, "backend": device.type,
               "rows": rows, "card": common.card_stamp(device)}
    common.write_json(out, "large_cone.json", payload)
    return payload


def cli(argv=None):
    ap = common.parser("One dense cone QP at n=9999 on one card.")
    ap.add_argument("-n", type=int, default=N)
    ap.add_argument("--mu", type=float, default=MU)
    a = ap.parse_args(argv)
    return main(a.n, a.mu, device=a.device, out=a.out)


if __name__ == "__main__":
    cli()
