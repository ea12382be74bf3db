"""Warm-started QP sequences: the time-stepping workload.

Counterpart of the JAX package's ``benchmarks/benchmark_warmstart_sequence.py``.
B independent box QPs (``A = G G^T + n I``, box [-1, 1], tol 2e-5, PCG with
a 500-matvec budget) whose right-hand sides drift by a random walk over T
steps (each step adds ``DRIFT * mean|b| * N(0, 1)``), solved cold (x0 = 0
every step) and warm (x0 = the previous step's solution).  The Hessians are
fixed, as in contact mechanics where a step moves the rhs a little.

The JAX script fuses the sequence into one ``lax.scan``, so that a remote
dispatch cost is paid once.  Here a host loop runs the steps, with each
step's drift drawn on the device from a generator seeded from the rep, so
cold and warm see the same walk.  The per-step statistics stay on the
device until the sequence ends.  Rows keep the JAX keys and add the f64
audit of the last step of the last rep (``true_residual_last_step``);
``matvec_ratio_cold_over_warm`` is algorithmic (1.98 in the JAX run, on
other draws), ``speedup`` the ratio of walls.

Run:  python -m ccqppy_tpu_torch.benchmarks.benchmark_warmstart_sequence
      [--device cuda|cpu] [--out DIR] [-B 512] [-n 1000] [--steps 20]
Writes ``warmstart_sequence.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models import pcg
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.utils.benchmark import dense_sweep_bytes, timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

B = 512
N = 1000
STEPS = 20
TOL = 2e-5
BUDGET = 500
DRIFT = 0.02       # rhs random-walk scale a step, relative to mean |b|
REPS = 3
SEED = 0
WALK_TAG = 1       # the walk of rep r is drawn from seed_of(WALK_TAG, r)


def walk(b0, scale, steps, rep):
    """The drift of each step of rep ``rep``: ``steps`` tensors like b0,
    drawn one at a time on b0's device."""
    gen = torch.Generator(device=b0.device).manual_seed(common.seed_of(WALK_TAG, rep))
    for _ in range(steps):
        yield scale * torch.randn(b0.shape, generator=gen, dtype=b0.dtype, device=b0.device)


def run_sequence(As, b0, drifts, proj, cfg, warm):
    """Solve the sequence ``b_t = b_{t-1} + drifts[t]``, each step from the
    previous solution (``warm``) or from 0.  Returns (the last step's x and
    b, per-step statistics (T, 4) in f64: the lanes' total matvecs, all
    converged, the max residual, a lane's max matvecs)."""
    b, x = b0, torch.zeros_like(b0)
    stats = []
    for d in drifts:
        b = b + d
        r = pcg.solve(As, b, x0=x if warm else torch.zeros_like(b), proj=proj, config=cfg)
        stats.append(torch.stack([r.matvecs.sum().double(), r.converged.all().double(),
                                  r.residual.max().double(), r.matvecs.max().double()]))
        x = r.x
    return x, b, torch.stack(stats)


def summarize(stats, B, wall, steps, true_residual):
    """A variant's row from its per-step statistics: the JAX keys and the
    f64 audit of the last step."""
    s = stats.cpu().numpy()
    return {
        "matvecs_total": int(s[:, 0].sum()),
        "sweeps_per_step_p50": float(np.median(s[:, 0])) / B,
        "sweeps_per_step_max": int(s[:, 3].max()),
        "wall_s": wall,
        "steps_per_s": steps / wall,
        "all_converged": bool(s[:, 1].all()),
        "residual_max": float(s[:, 2].max()),
        "true_residual_last_step": true_residual,
    }


def main(B=B, n=N, steps=STEPS, seed=SEED, device="cuda", dtype=torch.float32,
         out=common.DEFAULT_OUT):
    """Both variants; returns the JSON payload (also written to ``out``)."""
    device = common.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    As, bs, _ = random_qp_batch(gen, B, n, dtype, diag_boost=1.0)
    proj = box(-torch.ones(n), torch.ones(n), dtype=dtype, device=device)
    proj64 = common.f64_copy(proj)
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)
    scale = DRIFT * float(bs.abs().mean())

    def check(o):
        if not bool(o[2][:, 1].all()):
            raise RuntimeError("a step left a lane unconverged")

    rows = {}
    for label, warm in (("cold", False), ("warm", True)):
        # A conservative traffic floor: 10 f32 sweeps a step.
        res = timed_run(lambda A_, b_, d_, w=warm: run_sequence(A_, b_, d_, proj, cfg, w),
                        reps=REPS, make_args=lambda rep: (As, bs, walk(bs, scale, steps, rep)),
                        implied_bytes=dense_sweep_bytes(B, n, 10 * steps, As.element_size()),
                        check=check)
        x_T, b_T, stats = res.result
        tres = float(common.audit_residual(As, b_T, x_T, proj64).max())
        rows[label] = summarize(stats, B, res.wall_s, steps, tres)
        print(label, rows[label], flush=True)

    payload = {
        "B": B, "n": n, "steps": steps, "drift": DRIFT, "tol": TOL,
        "execution": "host loop over steps, drift drawn on the device per step from the "
                     "rep's generator (the same walk for both variants), warm start carried "
                     "on the device",
        "cold": rows["cold"], "warm": rows["warm"],
        "matvec_ratio_cold_over_warm": rows["cold"]["matvecs_total"]
        / max(rows["warm"]["matvecs_total"], 1),
        "speedup": rows["cold"]["wall_s"] / max(rows["warm"]["wall_s"], 1e-9),
        "backend": device.type,
        "card": common.card_stamp(device),
    }
    print({k: payload[k] for k in ("matvec_ratio_cold_over_warm", "speedup")})
    common.write_json(out, "warmstart_sequence.json", payload)
    return payload


def cli(argv=None):
    ap = common.parser("Warm-started QP sequences on one card.")
    ap.add_argument("-B", type=int, default=B)
    ap.add_argument("-n", type=int, default=N)
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    return main(a.B, a.n, a.steps, device=a.device, out=a.out)


if __name__ == "__main__":
    cli()
