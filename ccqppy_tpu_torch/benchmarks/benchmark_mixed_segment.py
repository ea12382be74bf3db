"""Interleaved cones and boxes through ``segment_product`` at full width.

Counterpart of the JAX package's ``benchmarks/benchmark_mixed_segment.py``:
B=1024 QPs of n=999 (``A = G G^T + n I``, ``b = -A x_uncon``, tol 1e-5, a
2000-matvec budget) under 333 dimension-3 blocks alternating Lorentz cones
(per-block mu in [0.5, 2]) and boxes (per-block half-widths in [0.5,
1.5]), the reference's ``DisjointProjOp`` pattern.  The blocks' parameters
are numpy's ``default_rng(7)`` draws in the JAX script's order, so the set
is the JAX script's own; the Hessians and right-hand sides are drawn with
a ``torch.Generator``.  ``segment_product`` groups the blocks into two
``SegmentProj`` groups (167 cones, 166 boxes).

Rows: ``apgd_sc`` on ``SpectralDense`` after ``estimate_spectral_bounds(As,
iters=32)`` (prep outside the clock) from the projected Jacobi start, 3
single calls, then pipelined at depth 10 (the headline; every pipelined
batch checked and audited); then fused MPRGP-BB as the comparison.  Where
the JAX script records the compile time of the first solve, this records
the time ``segment_set`` takes to build the set (``segment_build_s``);
``first_solve_incl_compile_s`` is the first call's wall, which compiles
nothing here (the kernels are built before).  The JAX run's p50 was 22
matvecs for ``apgd_sc`` (algorithmic).

Run:  python -m ccqppy_tpu_torch.benchmarks.benchmark_mixed_segment
      [--device cuda|cpu] [--out DIR] [-B 1024] [-n 999]
Writes ``mixed_segment_ensemble.json``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models.apgd import APGDSCConfig
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig
from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.ops.linop import SpectralDense, estimate_spectral_bounds
from ccqppy_tpu_torch.parallel import solve_batched
from ccqppy_tpu_torch.utils.benchmark import dense_sweep_bytes, synchronize, timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

N = 999            # 333 interleaved dim-3 blocks
BATCH = 1024
TOL = 1e-5
BUDGET = 2000
PIPELINE = 10
REPS = 3
SEED = 0
BLOCK_SEED = 7     # the JAX script's numpy seed of the block parameters
SPECTRAL_ITERS = 32
SWEEPS_FLOOR = 14  # least sweeps of a call, for the timing guard


def segment_blocks(n, dtype=torch.float32, device=None):
    """The (set, 3) blocks of the JAX script, in its order: even blocks
    Lorentz cones with mu ~ U(0.5, 2), odd ones boxes [-hw, hw] with
    hw ~ U(0.5, 1.5)^3 rounded to f32."""
    rng = np.random.default_rng(BLOCK_SEED)
    blocks = []
    for i in range(n // 3):
        if i % 2 == 0:
            blocks.append((P.lorentz_cone(float(rng.uniform(0.5, 2.0)), dtype, device), 3))
        else:
            hw = rng.uniform(0.5, 1.5, 3).astype(np.float32)
            blocks.append((P.box(-hw, hw, dtype, device), 3))
    return blocks


def segment_set(n, dtype=torch.float32, device=None):
    """The JAX script's set: ``segment_product`` of ``segment_blocks``, on
    ``device`` (``segment_product`` builds its coordinate index on the CPU).
    Its two groups hold the cones, then the boxes."""
    return P.segment_product(*segment_blocks(n, dtype, device)).to(device)


def jacobi_x0(proj, diag, b):
    """The projected Jacobi start ``proj(-b / diag A)``."""
    return proj.project(-b / diag)


def run_apgd_sc(sop, b, diag, proj, cfg):
    """One call of the headline row."""
    return solve_batched("apgd_sc", sop, b, x0=jacobi_x0(proj, diag, b), proj=proj, config=cfg)


def run_mprgp(As, b, diag, proj, cfg):
    """One call of the comparison row (fused MPRGP-BB)."""
    return solve_batched("mprgp_bb", As, b, x0=jacobi_x0(proj, diag, b), proj=proj, config=cfg)


def main(B=BATCH, n=N, device="cuda", dtype=torch.float32, out=common.DEFAULT_OUT):
    """The three rows; returns the JSON payload (also written to ``out``)."""
    device = common.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    As, bs, _ = random_qp_batch(gen, B, n, dtype, diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    t0 = time.perf_counter()
    proj = segment_set(n, dtype, device)
    build_s = time.perf_counter() - t0
    n_cones, n_boxes = proj.counts
    proj64 = common.f64_copy(proj)
    print(f"segment_product build ({n_cones} cones + {n_boxes} boxes, {len(proj.parts)} "
          f"groups): {build_s:.4f} s", flush=True)

    rows = []

    def audit_row(name, wall, r, b_used, extra=None):
        mvs = r.matvecs.double()
        row = {
            "solver": name, "n": n, "B": B, "tol": TOL,
            "wall_s": wall,
            "solves_per_s": B / wall,
            "converged": float(r.converged.double().mean()),
            "matvecs_p50": common.p50(r.matvecs),
            "matvecs_max": int(mvs.max()),
            "true_residual_max": float(common.audit_residual(As, b_used, r.x, proj64).max()),
            "implied_gbps": B * float(mvs.mean()) * n * n * As.element_size() / wall / 1e9,
            **(extra or {}),
        }
        rows.append(row)
        print(name, row, flush=True)
        return row

    # ---- headline: apgd_sc + spectral prep --------------------------------
    synchronize(As)
    t0 = time.perf_counter()
    L, mu = estimate_spectral_bounds(As, iters=SPECTRAL_ITERS)
    synchronize((L, mu))
    prep_s = time.perf_counter() - t0
    sop = SpectralDense(As, L, mu)
    sc_cfg = APGDSCConfig(tol=TOL, max_matvecs=BUDGET)

    def run_headline(b):
        return run_apgd_sc(sop, b, diag, proj, sc_cfg)

    t0 = time.perf_counter()
    synchronize(run_headline(bs))
    first_s = time.perf_counter() - t0

    implied = dense_sweep_bytes(B, n, SWEEPS_FLOOR, As.element_size())
    res = timed_run(run_headline, reps=REPS, implied_bytes=implied,
                    make_args=lambda rep: (common.perturbed(bs, 1, rep),), warmup=False)
    audit_row("apgd_sc + spectral prep", res.wall_s, res.result, common.perturbed(bs, 1, REPS - 1),
              {"prep_seconds_outside_clock": prep_s, "first_solve_incl_compile_s": first_s,
               "segment_build_s": build_s})

    # ---- pipelined steady-state headline -----------------------------------
    def check(r, b):
        common.require_converged(r, "apgd_sc pipelined")
        tres = float(common.audit_residual(As, b, r.x, proj64).max())
        if tres > TOL * 1.05:
            raise RuntimeError(f"apgd_sc pipelined: audited residual {tres} above tol")

    wall, outs, b_used = common.pipelined(run_headline, bs, 100, PIPELINE, implied, check)
    audit_row("apgd_sc pipelined (headline)", wall, outs[-1], b_used[-1],
              {"pipeline_depth": PIPELINE})

    # ---- comparison: fused MPRGP-BB ----------------------------------------
    cfg = MPRGPBBConfig(tol=TOL, max_matvecs=BUDGET, fused=True)
    res = timed_run(lambda b: run_mprgp(As, b, diag, proj, cfg), reps=2, implied_bytes=implied,
                    make_args=lambda rep: (common.perturbed(bs, 2, rep),))
    audit_row("mprgp_bb fused plain", res.wall_s, res.result, common.perturbed(bs, 2, 1))

    payload = {"backend": device.type,
               "workload": f"B={B} n={n} INTERLEAVED per-block-parameter {n_cones} Lorentz "
                           f"cones (mu in [0.5,2]) + {n_boxes} boxes (half-width in [0.5,1.5]), "
                           f"dim-3 blocks via segment_product, conditioned Wishart, tol {TOL:g}",
               "timing": "roofline-guarded timed_run; headline = steady-state pipelined calls; "
                         "every pipelined batch convergence-checked and residual-audited",
               "rows": rows,
               "card": common.card_stamp(device)}
    common.write_json(out, "mixed_segment_ensemble.json", payload)
    return payload


def cli(argv=None):
    ap = common.parser("Interleaved cones and boxes through segment_product on one card.")
    ap.add_argument("-B", type=int, default=BATCH)
    ap.add_argument("-n", type=int, default=N)
    a = ap.parse_args(argv)
    return main(a.B, a.n, a.device, out=a.out)


if __name__ == "__main__":
    cli()
