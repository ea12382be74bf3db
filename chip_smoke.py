#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU and check it.

The main path is the batched 1000-dim box-QP workload: B independent QPs
with ``A = G G^T + n I`` (G standard normal), ``b = -A x_uncon``
(x_uncon ~ U(-1, 1)), box [-1, 1], tol 2e-5, a 500-matvec budget, and
right-hand sides perturbed by 1e-3 N(0, 1) per call.  Three box modes:

* iterative (B=2048): Jacobi warm start ``clip(-b / diag A, -1, 1)``, then
  verified PCG with fused straggler compaction (phase 1 at 17 matvecs, a
  256-lane bucket), on the dense stack through the GEMV kernel;
* packed (the same B=2048 ensemble): the same solve on
  ``SymmetricPackedDense.from_dense(As, tile=256)``, whose matvec streams
  only the upper tiles through the symv kernel;
* (l) single request, packed: lane 0 of the same ensemble alone,
  ``SymmetricPackedDense.from_dense(As[:1], tile=256)``, whose matvec at
  B=1 is the single-problem wrapper ``symv_packed``: PCG from the Jacobi
  start, uncompacted.  One QP answered alone, the latency case of a packed
  ensemble's users; its wall is host-bound (~100 small kernels an
  iteration around a few-microsecond symv), not a kernel measurement;
* direct serving (B=1024): a one-time batched Cholesky inverse, then per
  call the projected inverse apply, a verification sweep and a compacted
  PCG polish (phase 1 at 3 matvecs, a 64-lane bucket).

Two more box modes run on the iterative mode's B=2048 ensemble, from the
same Jacobi start:

* (e) bbpgd_f: ``solve_batched("bbpgd_f", ...)``, the README's batched
  quick start, every matvec an f32 GEMV launch;
* (f) mixed: ``solve_batched_mixed``, the bf16 -> f32 precision ladder:
  BBPGDf on a bf16 copy of the stack (built once by ``prepare_dense_batch``,
  outside the clock) through the GEMV kernel's bf16 instance, a verified
  f32 PCG polish, and an MPRGP-BB fixup of the stragglers.

Beside them, a check: residual-replacement PCG on
``MixedPrecDense(As, As16)`` (refresh every 16) and plain PCG, both from
x = 0, audited once, then timed in interleaved pairs ("rr pairs").

The sixth mode, cone, is the cone ensemble of
``benchmarks/benchmark_cone_ensemble.py`` at its full width: B=1024 QPs of
n=999 under 333 Lorentz-cone blocks of dimension 3 (mu=1), the same
Hessian family, tol 1e-5, a 2000-matvec budget, right-hand sides perturbed
per call.  Its prep is ``estimate_spectral_bounds`` (outside the clock,
checked on 16 lanes against the plain f64 version and against eigvalsh);
every call starts from the cone-Jacobi point ``proj(-b / diag A)``.  Two
runs: (a) ``apgd_sc`` on ``SpectralDense``, the headline; (b) fused
MPRGP-BB with straggler compaction (phase 1 at 43 matvecs, a 256-lane
bucket); (g) SPG, the benchmark's SPG row: ``solve_batched("spg", ...)``
from x = 0 with per-lane keys from seed 1, then one untimed, audited call
of ``solve_batched_fused_compact("spg", ...)`` with the same keys, phase 1
at twice the first call's p50 and a 256-lane bucket, so that phase 2 runs
on ``fold_in(keys, 1)``; (h) APGD-AR, the disjoint study's solver, from
the cone-Jacobi start.  Every matvec of the mode is the GEMV kernel.

The box section adds (i) classic APGD, the single-constraint study's
solver, on the iterative mode's ensemble from its Jacobi start, at the
study's budget of 5000 matvecs.  Then the README's quick start: SPG on
its 3x3 box QP at B=1.

Two modes take f64 and a sparse operator onto the card, each the
configuration of a JAX benchmark unchanged:

* (j) the f64-exact rung of ``benchmarks/benchmark_f64_wishart1k.py``:
  B=64 raw Wishart QPs (``diag_boost=0``, condition ~1e5-1e7) of n=1000 in
  f64, box [-1, 1], from the Jacobi start, residual-replacement PCG on
  ``MixedPrecDense(A, A.float())`` (refresh every 128, segment drop 0.25):
  every cheap sweep the GEMV kernel's f32 instance, every refresh its f64
  instance.  The row at tol 1e-5 with a budget of 20,000: 3 timed calls,
  each one call with per-lane stopping, none of the benchmark's
  continuation chunks.  Beside it, plain f64 PCG on ``DenseOperator(A)``
  (the f64 instance) on the same right-hand sides.  The benchmark's row at
  tol 1e-10 takes minutes on the card: ``tools/f64_deep.py`` runs it.
* (k) the huge QP of ``benchmarks/benchmark_huge_qp.py``: one box QP of
  n = 1,000,000 on a block-tridiagonal ``BlockSparseOperator`` (4x4 blocks,
  3 a block-row, 48 MB of f32, numpy's draws of the benchmark's builder),
  PCG at tol 1e-9 with a budget of 10,000, b perturbed by 1e-4 N(0, 1) per
  call.  Its matvec is plain PyTorch: the mode launches no kernel of the
  package.

Then the distributed layer, at world 1 over a real NCCL process group
(``parallel.distributed.init_distributed`` on 127.0.0.1, the script's own
``NCCL_SOCKET_IFNAME=lo``; a failed init fails the run): every all-gather
and all-reduce is an NCCL call on device memory.

* (m) (k)'s QP row-sharded: ``solve_sharded_blocksparse`` on (k)'s
  operator and right-hand sides.  Its matvec count and x must equal (k)'s
  bitwise (a one-rank all-gather and all-reduce change no value), with at
  least one NCCL all-gather a matvec.
* (n) one dense QP of the box family at n = 16,384 (1.07 GB f32, built on
  the card with TF32 off), row-sharded: ``solve_sharded`` with Jacobi PCG
  (the sharded ``diagonal()``) from the Jacobi start, tol 2e-5, budget
  500, audited in f64 in row chunks; its local product (``torch.matmul``,
  an XLA dot in the JAX package, not a kernel) is timed against its bound.
* (o) the iterative ensemble (B=2048, n=1000) scenario-sharded:
  ``solve_batched_sharded`` with PCG from the Jacobi start, lane for lane
  bitwise ``solve_batched`` on the same inputs, through the GEMV kernel,
  with no collective in the solve.  The one rank slices its lanes (a view
  of the whole stack, b and x0) as a rank of any axis size does.

Then ``scaling_probe([1])`` prints its row and the process group is
destroyed.

Last, (p) the reference API, the port's user-facing surface beside the
functional one, on the card:

* the eight ``compat.CCQPSolver*`` classes on the six oracle problems of
  ``utils.problems`` (the reference suite's five and the README's), in f64
  at tol 1e-8 with a 10,000 budget as the reference's own tests run them,
  each solution within 1e-5 of the exact one and each solve audited by
  ``utils.diagnostics.check_result``; then the compat docstring's example,
  ``CCQPSolverSPG(1e-10, 5000)`` with a ``BoxProjOp``.  f64 GEMV launches
  are required;
* ``check_result`` on the iterative mode's warm-up result (B=2048,
  n=1000), its ensemble drawn again from the generator state it was drawn
  from: ok and consistent;
* ``utils.benchmark.BenchmarkRandomCCQP`` at the random-ensemble study's
  widest size (64 trials, tol 1e-5, a 5000 budget, f32): pcg and bbpgd_f
  over the five single-constraint families at n=512, mprgp_bb over the
  disjoint Lorentz-cone family at n=513.  Every timed rep must leave a
  feasible, finite x, every pcg cell converge on every lane, and f32 GEMV
  launches are required.  The phase's GEMV launches are printed on a line
  of their own; the JSON line's counts stay the main path's.

Steps: build the CUDA kernels from ``ccqppy_tpu_torch/csrc``; read the
launch floor (the device time of an in-place add on a one-element
tensor); hold each kernel's entry points against their plain PyTorch
versions on the card (the GEMV also on A and x at storage offsets of 1-3
elements, bitwise; the symv at the row slices ``symv.row_slices`` picks,
and at one slice, bitwise where one slice is the pick); time the GEMV
against ``einsum`` in interleaved pairs at seven shapes (in f64 also
against ``torch.bmm``; "gemv pairs") and the single-problem symv at its
row slices against one slice ("symv pairs"); run the modes and the rr-PCG
check at full width,
audit every lane's true residual in f64 independently of the kernels (the
plain GEMV of the dense stack; for (k) the plain f64 block-sparse matvec),
and check that the kernels carried each mode (launch counts are zeroed
just before a mode and read just after it; ``gemv.LAUNCHES_BF16`` and
``gemv.LAUNCHES_F64`` count the bf16 and f64 launches among
``gemv.LAUNCHES``).  Any failed check
raises, so the exit code is non-zero.  The last line of standard output is
one JSON object naming the device.

Every kernel and library time is device-only (``utils.benchmark.device_ms``:
a spin on the stream holds the start event until the host has enqueued the
call; a rep whose enqueue outlasted its spin is never kept but taken again
behind a longer spin, and three such reps in a row raise).  For one shape of
each kernel the earlier host-inclusive reading (``host_inclusive_ms``) is
printed beside it.  Mode walls are host clocks around synchronised calls.

Run:  python3 chip_smoke.py      (needs one CUDA GPU, nvcc for sm_90a)
"""
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from ccqppy_tpu_torch import compat
from ccqppy_tpu_torch.models import pcg, spg
from ccqppy_tpu_torch.models.apgd import APGDConfig, APGDSCConfig
from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.models.bbpgd import BBPGDfConfig
from ccqppy_tpu_torch.models.direct import solve_direct_batched, spd_inverse_batch
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.models.spg import SPGConfig
from ccqppy_tpu_torch.ops import collectives, gemv, kernels, symv
from ccqppy_tpu_torch.ops.linop import (BlockSparseOperator, CastDense, DenseOperator,
                                        MixedPrecDense, ShardedDenseOperator, SpectralDense,
                                        SymmetricPackedDense, estimate_spectral_bounds)
from ccqppy_tpu_torch.ops.projections import blockwise, box, lorentz_cone
from ccqppy_tpu_torch.parallel import (init_distributed, make_batch_mesh, make_mesh,
                                       prepare_dense_batch, scaling_probe, solve_batched,
                                       solve_batched_fused_compact, solve_batched_mixed,
                                       solve_batched_sharded, solve_sharded,
                                       solve_sharded_blocksparse)
from ccqppy_tpu_torch.parallel.distributed import COLLECTIVES, free_port, mesh_axis
from ccqppy_tpu_torch.utils import problems
from ccqppy_tpu_torch.utils.benchmark import (BenchmarkRandomCCQP, default_families,
                                              dense_sweep_bytes, device_ms,
                                              disjoint_families, timed_run)
from ccqppy_tpu_torch.utils.diagnostics import check_result
from ccqppy_tpu_torch.utils.random_qp import block_tridiag_qp, random_qp_batch
from ccqppy_tpu_torch.utils.rng import split_keys

N = 1000
TOL = 2e-5
BUDGET = 500
SEED = 0
NOISE = 1e-3

B_ITER = 2048
PHASE1 = 17        # p50 sweep count + the verification sweep
BUCKET = 256

TILE_PACKED = 256  # n = 1000 padded to 1024: 10 tiles, 0.655x the dense bytes

# Least sweeps of one call, for the timing guard: (e) the two init sweeps
# and a few BB steps; (f) phase A's three bf16 sweeps (2 bytes an element)
# and phase B's init and verification f32 sweeps (4 bytes).
SWEEPS_BB = 10
SWEEPS_MIXED_BF16, SWEEPS_MIXED_F32 = 3, 2
PHASE_A_TOL, PHASE_A_BUDGET = 5e-3, 48   # the ladder's defaults
REFRESH_EVERY = 16                       # rr-PCG check
RR_ROUNDS = 6      # interleaved rounds of plain PCG and rr-PCG

B_DIRECT = 1024    # As and A^-1 both resident
PHASE1_DIRECT = 3
BUCKET_DIRECT = 64

N_CONE = 999       # 333 Lorentz blocks of dimension 3
B_CONE = 1024
TOL_CONE = 1e-5
BUDGET_CONE = 2000
PHASE1_CONE = 43   # MPRGP-BB: ~p95 of the warm-started sweep count
BUCKET_CONE = 256
SEED_SPG = 1       # (g): the benchmark's split(PRNGKey(1), B), as port keys
# Least sweeps of one call, for the timing guard: SPG's two init sweeps and
# one step; APGD's L0 sweep and one step's two.
SWEEPS_SPG = SWEEPS_APGD = 3
BUDGET_APGD = 5000  # (i): the single-constraint study's budget
# (i)'s tol, not the study's 2e-5.  In f32 classic APGD's residual does not
# settle: it bounces in a band (median ~3.5e-4 at n=256 in both packages,
# tests/test_torch_apgd.py::test_apgd_f32_residual_band_matches_jax), and a
# lane exits when a dip of the band crosses tol.  At n=1000 dips below 2e-5
# are 0.2-4% of the iterations, below 1e-4 12-18%, and at 2e-5 one lane of
# 256 spent the 5000-matvec budget (tools/f32_cpu_study.py, seeds 0 and 5).
TOL_APGD_BOX = 1e-4
BOUND_LANES = 16   # lanes whose spectral bounds are checked
BOUND_TOL = 1e-4   # f32 kernel estimate against the plain f64 estimate, relative
SPECTRUM_TOL = 0.03  # |L / lambda_max - 1| and |mu / lambda_min - 1|

# (j): benchmarks/benchmark_f64_wishart1k.py.
B_F64 = 64
TOL_F64, BUDGET_F64 = 1e-5, 20_000   # the benchmark's 1e-10 row: tools/f64_deep.py
REFRESH_F64, SEGMENT_DROP_F64 = 128, 0.25
# Least sweeps of one call, for the timing guard: the benchmark's 100 f32
# sweeps a lane for the rung; 20 f64 sweeps for plain PCG.
SWEEPS_RUNG, SWEEPS_F64_PLAIN = 100, 20
# (k): benchmarks/benchmark_huge_qp.py.
N_HUGE = 1_000_000
TOL_HUGE, BUDGET_HUGE = 1e-9, 10_000
NOISE_HUGE = 1e-4
SWEEPS_HUGE = 20   # the benchmark's traffic floor: 20 sweeps of the blocks
SEED_HUGE = 0      # the benchmark's default_rng seed
# (m), (n), (o): the distributed layer at world 1 over NCCL.
DIST_TIMEOUT = 120     # seconds: the rendezvous and every collective
N_SHARDED = 16_384     # (n): one dense QP of 1.07 GB f32
SWEEPS_SHARDED = 10    # (n): least sweeps of one call, for the timing guard
AUDIT_ROWS = 2048      # (n): rows of A a chunk of the f64 audit
COLLECTIVE_REPS = 200  # calls in a row of each collective timed after (m)
# (p) the reference API: the reference's own tests run the compat solvers in
# f64 at tol 1e-8 with a 10,000 budget (PGD at step 0.1) and hold every
# solution to 1e-5 of the exact one.
ORACLE_TOL, ORACLE_BUDGET, ORACLE_ERR = 1e-8, 10_000, 1e-5
# The random-ensemble study at its widest size (benchmarks/
# benchmark_random_ccqp.py): 64 trials, n = 512 (513 for the 3-blocks of the
# disjoint families), tol 1e-5, a 5000 budget, diag_boost 1, f32.
HARNESS_T, HARNESS_N, HARNESS_N_DJ = 64, 512, 513
HARNESS_TOL, HARNESS_BUDGET = 1e-5, 5000
HARNESS_SOLVERS, HARNESS_SOLVERS_DJ = ("pcg", "bbpgd_f"), ("mprgp_bb",)

REPS = 3           # timed reps per mode
KERNEL_REPS = 25   # timed launches per kernel measurement

# The card's peaks for a kernel's bound: the larger of bytes over the memory
# rate and FLOPs over the rate outside the tensor cores for the kernel's
# type (every kernel here does fp32 FMA, the GEMV's f64 instance f64 FMA).
# NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32, 33.5 TFLOP/s
# fp64 (not the 67 of the fp64 tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 33.5e12

GEMV_F32_TOL = 1e-5    # max|y - y_ref| / max|y_ref| against the f64 plain version
GEMV_BF16_TOL = 2e-2   # bf16 A against the f64 GEMV of the f32 A (quantization)
GEMV_BF16_PLAIN_TOL = 1e-5  # bf16 kernel against the plain bf16 version
GEMV_F64_TOL = 1e-13   # f64 kernel against the plain f64 version (the sums' order)
# (A, x) storage offsets in elements of the GEMV's bitwise check.
GEMV_OFFSETS = ((1, 0), (2, 3), (3, 1), (0, 2))
PAIR_ROUNDS = 10       # interleaved rounds of kernel, then plain version
# (B, n, dtype) of the pairs: the iterative phase 1, the cone runs, the two
# phase-2 straggler buckets (PERF.md section 5), bf16 A, and f64 at the
# rung's shape and at 1024 lanes.
PAIR_SHAPES = ((B_ITER, N, torch.float32), (B_CONE, N_CONE, torch.float32),
               (120, N, torch.float32), (41, N_CONE, torch.float32),
               (B_ITER, N, torch.bfloat16), (B_F64, N, torch.float64),
               (1024, N, torch.float64))
SYMV_TOL = 1e-5        # max rel err against the f64 plain version (the JAX bound)
# (B, n, tile) of the symv checks; the last is the packed mode's shape, and
# its lane 0 the single-problem shape of mode (l).
SYMV_SHAPES = ((3, 512, 128), (3, 512, 256), (2, 1024, 512), (2048, 1024, 256))
SYMV_PAIR_ROUNDS = 10  # interleaved rounds of symv_packed at its row slices and at one


def require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def zero_counts():
    """Set every kernel's launch count to 0, just before a mode runs."""
    gemv.LAUNCHES = gemv.LAUNCHES_BF16 = gemv.LAUNCHES_F64 = 0
    symv.LAUNCHES.update(dict.fromkeys(symv.LAUNCHES, 0))
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))


def jacobi_x0(diag, b):
    return torch.clamp(-b / diag, -1.0, 1.0)


def run_iterative(As, b, diag, proj, cfg):
    """One call of the iterative mode."""
    return solve_batched_fused_compact(
        "pcg", As, b, PHASE1, x0=jacobi_x0(diag, b), proj=proj, config=cfg,
        bucket=BUCKET, host_fallback=False)


def run_bbpgd_f(As, b, diag, proj, cfg):
    """One call of mode (e): the README's batched quick start."""
    return solve_batched("bbpgd_f", As, b, x0=jacobi_x0(diag, b), proj=proj, config=cfg)


def run_mixed(As, As16, b, diag, proj, cfg):
    """One call of mode (f): the bf16 -> f32 precision ladder."""
    return solve_batched_mixed(As, b, proj=proj, config=cfg, As_low=As16,
                               x0=jacobi_x0(diag, b))


def run_phase_a(As16, b, diag, proj, cfg):
    """Phase A of mode (f) alone, to read its per-lane matvecs."""
    return solve_batched("bbpgd_f", CastDense(As16), b, x0=jacobi_x0(diag, b), proj=proj,
                         config=BBPGDfConfig(tol=PHASE_A_TOL, max_matvecs=PHASE_A_BUDGET,
                                             gd=cfg.gd))


def run_packed(op, b, proj, cfg):
    """One call of the packed mode: the iterative mode on a packed operator."""
    return solve_batched_fused_compact(
        "pcg", op, b, PHASE1, x0=jacobi_x0(op.diagonal(), b), proj=proj,
        config=cfg, bucket=BUCKET, host_fallback=False)


def run_single(op1, b, proj, cfg):
    """One call of mode (l): PCG on one packed problem from the Jacobi
    start, uncompacted."""
    return pcg.solve(op1, b, x0=jacobi_x0(op1.diagonal(), b), proj=proj, config=cfg)


def run_direct(Ainv, As, b, proj, cfg):
    """One call of the direct serving mode."""
    return solve_direct_batched(Ainv, As, b, proj, cfg, phase1=PHASE1_DIRECT,
                                bucket=BUCKET_DIRECT, host_fallback=False)


def cone_proj(dtype=torch.float32, device=None):
    """333 Lorentz-cone blocks of dimension 3, mu = 1."""
    return blockwise(lorentz_cone(1.0, dtype=dtype, device=device), 3)


def cone_x0(proj, diag, b):
    """The cone-Jacobi warm start proj(-b / diag A)."""
    return proj.project(-b / diag)


def run_cone_apgd(sop, b, proj, cfg):
    """One call of the cone mode's run (a): apgd_sc on SpectralDense."""
    return solve_batched("apgd_sc", sop, b, x0=cone_x0(proj, sop.diagonal(), b),
                         proj=proj, config=cfg)


def run_cone_mprgp(As, b, diag, proj, cfg):
    """One call of the cone mode's run (b): fused MPRGP-BB with compaction."""
    return solve_batched_fused_compact(
        "mprgp_bb", As, b, PHASE1_CONE, x0=cone_x0(proj, diag, b), proj=proj,
        config=cfg, bucket=BUCKET_CONE, host_fallback=False)


def run_cone_spg(As, b, proj, cfg, keys):
    """One call of (g): the benchmark's SPG row, from x = 0."""
    return solve_batched("spg", As, b, proj=proj, config=cfg, keys=keys)


def run_cone_spg_compact(As, b, proj, cfg, keys, phase1):
    """(g) with fused straggler compaction: phase 2 on fold_in(keys, 1)."""
    return solve_batched_fused_compact("spg", As, b, phase1, proj=proj, config=cfg,
                                       bucket=BUCKET_CONE, keys=keys)


def run_cone_apgd_ar(As, b, diag, proj, cfg):
    """One call of (h): APGD-AR from the cone-Jacobi start."""
    return solve_batched("apgd_ar", As, b, x0=cone_x0(proj, diag, b), proj=proj, config=cfg)


def run_box_apgd(As, b, diag, proj, cfg):
    """One call of (i): classic APGD from the Jacobi start."""
    return solve_batched("apgd", As, b, x0=jacobi_x0(diag, b), proj=proj, config=cfg)


def run_rung(As, As32, b, diag, proj, cfg):
    """One call of (j): rr-PCG on the f64-exact rung from the Jacobi start."""
    return pcg.solve(MixedPrecDense(As, As32), b, x0=jacobi_x0(diag, b), proj=proj, config=cfg)


def run_f64_plain(As, b, diag, proj, cfg):
    """Beside (j): plain PCG on the f64 stack from the same start."""
    return pcg.solve(DenseOperator(As), b, x0=jacobi_x0(diag, b), proj=proj, config=cfg)


def run_huge(op, b, proj, cfg):
    """One call of (k): PCG on the block-sparse QP from the default start,
    as the benchmark calls it."""
    return pcg.solve(op, b, proj=proj, config=cfg)


def run_huge_sharded(op, b, proj, cfg, mesh):
    """One call of (m): (k)'s solve row-sharded over ``mesh``."""
    return solve_sharded_blocksparse("pcg", op.blocks, op.cols, b, mesh, proj=proj, config=cfg)


def run_dense_sharded(A, b, proj, cfg, mesh):
    """One call of (n): PCG on one dense QP row-sharded over ``mesh``, from
    the Jacobi start."""
    return solve_sharded("pcg", A, b, mesh, x0=jacobi_x0(A.diagonal(dim1=-2, dim2=-1), b),
                         proj=proj, config=cfg)


def run_scenario_sharded(As, b, diag, proj, cfg, mesh):
    """One call of (o): PCG on the ensemble scenario-sharded over ``mesh``,
    from the Jacobi start."""
    return solve_batched_sharded("pcg", As, b, mesh, x0=jacobi_x0(diag, b), proj=proj,
                                 config=cfg)


def compat_solvers(device):
    """The eight drop-in solver classes as the reference's tests build them."""
    args = (ORACLE_TOL, ORACLE_BUDGET)
    return [compat.CCQPSolverPGD(*args, 0.1, device=device),
            *(getattr(compat, name)(*args, device=device)
              for name in ("CCQPSolverAPGD", "CCQPSolverAPGDAntiRelaxation", "CCQPSolverBBPGD",
                           "CCQPSolverBBPGDf", "CCQPSolverSPG", "CCQPSolverMPRGP",
                           "CCQPSolverMPRGPBB"))]


def run_oracle(device):
    """(p) 1: the eight compat solvers on the six oracle problems (the five
    of the reference suite and the README's), f64 at tol 1e-8, each solve
    audited by ``check_result``; then the compat docstring's example,
    ``CCQPSolverSPG(1e-10, 5000)`` with a ``BoxProjOp`` on the README
    problem.  Every solution must lie within ORACLE_ERR of the exact one.
    Returns one row a solve: (problem, solver, matvecs, |x - x*|, residual,
    solution_time)."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        rows = []
        for p in problems.all_problems(torch.float64, device) + [
                problems.readme_problem(torch.float64, device)]:
            x_exact = p.exact_solution[0].cpu().numpy()
            for solver in compat_solvers(device):
                solver.solve(p.A[0], p.b[0], convex_proj_op=p.proj)
                err = float(np.abs(solver.solution - x_exact).max())
                require(solver.solution_converged and err < ORACLE_ERR,
                        f"oracle {p.name} / {solver.name}: converged "
                        f"{solver.solution_converged}, max |x - x*| {err}")
                check_result(solver.result, proj=p.proj, A=p.A, b=p.b)
                rows.append((p.name, solver.name, solver.solution_num_matrix_vector_multiplications,
                             err, solver.solution_residual, solver.solution_time))
        p = problems.readme_problem(torch.float64, device)
        op = compat.BoxProjOp(3, [-2.0, -2.0, -4.0], [2.0, 2.0, 5.0], device=device)
        solver = compat.CCQPSolverSPG(1e-10, 5000, device=device).solve(
            p.A[0].cpu().numpy(), p.b[0].cpu().numpy(), convex_proj_op=op)
        err = float(np.abs(solver.solution - p.exact_solution[0].cpu().numpy()).max())
        require(solver.solution_converged and err < ORACLE_ERR,
                f"compat example: converged {solver.solution_converged}, max |x - x*| {err}")
        check_result(solver.result, proj=op.core, A=p.A, b=p.b)
        rows.append(("compat example", solver.name, solver.solution_num_matrix_vector_multiplications,
                     err, solver.solution_residual, solver.solution_time))
    finally:
        torch.set_default_dtype(saved)
    return rows


def check_full_width(r, As, bs, proj):
    """(p) 2: ``check_result`` on a result of the iterative mode with its
    projection, A and b; it must be ok and consistent.  Returns the
    report."""
    rep = check_result(r, proj=proj, A=As, b=bs, raise_on_fail=False)
    require(rep["ok"] and rep["residual_consistent"], f"check_result at full width: {rep}")
    return rep


def harness_families(device):
    """(p) 3's families: the five single-constraint ones at HARNESS_N, and
    the disjoint Lorentz-cone one at HARNESS_N_DJ."""
    return (default_families(torch.float32, device),
            {"dj_cone": disjoint_families(3, torch.float32, device)["dj_cone"]})


def run_harness(device):
    """(p) 3: one ``BenchmarkRandomCCQP.run()`` of HARNESS_SOLVERS over the
    single-constraint families at HARNESS_N and one of HARNESS_SOLVERS_DJ
    over dj_cone at HARNESS_N_DJ, HARNESS_T trials a cell.  Every timed rep
    of every cell must leave a feasible, finite x; every pcg cell must
    converge on every lane; each result's ``to_json`` must round-trip.
    Returns the two results."""
    results = []
    for solvers, fams, n in zip((HARNESS_SOLVERS, HARNESS_SOLVERS_DJ), harness_families(device),
                                (HARNESS_N, HARNESS_N_DJ)):
        def check(sname, fam, n_, r, fams=fams):
            proj = fams[fam](n_, torch.float32)
            require(bool(torch.isfinite(r.x).all()) and bool(proj.contains(r.x).all()),
                    f"harness {sname} / {fam} n={n_}: an infeasible or non-finite x")
        bench = BenchmarkRandomCCQP(HARNESS_T, solvers, fams, [n], tol=HARNESS_TOL,
                                    max_matvecs=HARNESS_BUDGET, dtype=torch.float32,
                                    diag_boost=1.0, seed=SEED, device=device)
        res = bench.run(verbose=False, check=check)
        back = json.loads(res.to_json())
        require(back["families"] == list(fams) and back["sizes"] == [n]
                and np.array_equal(np.asarray(back["matvecs"]), res.matvecs)
                and np.array_equal(np.asarray(back["converged"]), res.converged),
                "harness: to_json does not round-trip")
        if "pcg" in solvers:
            conv = res.converged[solvers.index("pcg")]
            require(bool(conv.all()), f"harness: pcg converged {conv.mean(axis=-1).tolist()} "
                                      f"over {list(fams)}")
        results.append(res)
    return results


def audit_rows(A, b, x, chunk=AUDIT_ROWS):
    """True Eq. 25 residual of one QP (B = 1) in f64 on the box [-1, 1],
    with the product taken in row chunks of f64 copies of A."""
    x64 = x.double()
    Ax = torch.cat([A[:, i:i + chunk].double() @ x64[..., None]
                    for i in range(0, A.shape[1], chunk)], dim=1)[..., 0]
    n = A.shape[-1]
    proj64 = box(-torch.ones(n), torch.ones(n), dtype=torch.float64, device=x.device)
    return pg_residual(proj64, x64, Ax + b.double(), 1e-6)


def collective_host_ms(x, group, reps=COLLECTIVE_REPS):
    """Wall per call, in ms, of the sharded operators' collectives at this
    world size, ``reps`` calls in a row and then a synchronise: an
    all-gather of ``x``, an all-reduce SUM of one value a lane, and for
    scale an in-place add on that value (one small kernel)."""
    one = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    out = {}
    for name, fn in (("all_gather", lambda: collectives.all_gather_last(x, group)),
                     ("all_reduce_sum", lambda: collectives.all_reduce(one, "sum", group)),
                     ("add_", lambda: one.add_(1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def collectives_line(counts, iterations):
    return (f"collectives {dict(counts)}, {sum(counts.values()) / max(iterations, 1):.2f} an "
            f"iteration over {iterations} iterations")


def f32_launches():
    """The f32 GEMV launches among ``gemv.LAUNCHES``."""
    return gemv.LAUNCHES - gemv.LAUNCHES_F64 - gemv.LAUNCHES_BF16


def readme_qp(dev):
    """The README's quick start at B=1: a 3x3 QP whose optimum [1, 0, 1]
    lies inside the box [-2, 2] x [-2, 2] x [-4, 5]."""
    A = torch.tensor([[[2., -1., 0.], [-1., 2., -1.], [0., -1., 2.]]], device=dev)
    b = -gemv.batched_gemv_reference(A, torch.tensor([[1., 0., 1.]], device=dev))
    return A, b, box([-2., -2., -4.], [2., 2., 5.], device=dev)


def apgd_trials(r, launches):
    """Backtracking trials of an APGD call: per lane, the matvecs beyond the
    L0 sweep and two a step; batched, the GEMV launches beyond the L0 sweep
    and two for each step of the slowest lane."""
    per_lane = r.matvecs - 1 - 2 * r.iterations
    return int(per_lane.sum()), int(per_lane.max()), launches - 1 - 2 * int(r.iterations.max())


def chunked_f64(plain, *args, chunk=256):
    """A plain version in f64, in lane chunks to bound the f64 copies."""
    return torch.cat([plain(*(a[i:i + chunk].double() for a in args))
                      for i in range(0, args[0].shape[0], chunk)])


def gemv_f64(A, x):
    """Plain GEMV in f64."""
    return chunked_f64(gemv.batched_gemv_reference, A, x)


def audit_residual(As, b, x, proj64=None):
    """True Eq. 25 residual of every lane in f64, independent of the kernel;
    the box [-1, 1] unless ``proj64`` (an f64 set) is given."""
    if proj64 is None:
        proj64 = box(-torch.ones(N), torch.ones(N), dtype=torch.float64,
                     device=x.device)
    g = gemv_f64(As, x) + b.double()
    return pg_residual(proj64, x.double(), g, 1e-6)


def audit_blocksparse(op, b, x):
    """True Eq. 25 residual of every lane in f64 on the box [-1, 1], through
    the plain f64 matvec of an f64 copy of the block-sparse operator."""
    op64 = BlockSparseOperator(op.blocks.double(), op.cols)
    proj64 = box(-torch.ones(op.n), torch.ones(op.n), dtype=torch.float64, device=x.device)
    return pg_residual(proj64, x.double(), op64.matvec(x.double()) + b.double(), 1e-6)


def host_inclusive_ms(fn, reps=KERNEL_REPS, warmup=3):
    """The earlier timer, printed beside ``device_ms`` for one shape of each
    kernel: CUDA events around ``fn()`` on an idle stream, so the reading
    holds the host's enqueue as well as the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``flops`` operations at ``peak_flops``, and which of
    the two sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemv_bound(A, x):
    """A and x read once, y (x's dtype) written once; 2 FLOPs per element
    of A, at the f64 rate for an f64 A."""
    peak = PEAK_F64_FLOPS if A.dtype == torch.float64 else PEAK_F32_FLOPS
    return bound(A.numel() * A.element_size() + 2 * x.numel() * x.element_size(),
                 2 * A.numel(), peak)


def rel_err(y, ref):
    return float((y.double() - ref).abs().max() / ref.abs().max())


def offset_view(t, offset):
    """t's values as a contiguous view ``offset`` elements into a larger
    buffer, so its base is aligned as the offset makes it; NaN before the
    view and in the 16 bytes after it."""
    pad = 16 // t.element_size()
    buf = torch.full((offset + t.numel() + pad,), torch.nan, dtype=t.dtype, device=t.device)
    buf[offset:offset + t.numel()] = t.reshape(-1)
    return buf[offset:offset + t.numel()].view(t.shape)


def check_offsets(name, A, x, y):
    """The GEMV of A and x at the storage offsets GEMV_OFFSETS is bitwise y:
    the alignment changes nothing, and no value from outside A or x (NaN
    there) enters."""
    for a_off, x_off in GEMV_OFFSETS:
        y_off = gemv.batched_gemv(offset_view(A, a_off), offset_view(x, x_off))
        require(torch.equal(bits(y_off), bits(y)),
                f"{name}: A at offset {a_off}, x at {x_off} changed y")
    print(f"{name}: bitwise equal at (A, x) storage offsets {GEMV_OFFSETS}")


def check_kernels(gen, dev):
    """Kernel against plain version on the card; returns the measurements."""
    before = gemv.LAUNCHES
    for B, n in ((3, 999), (3, 37), (BUCKET, N)):
        A = torch.randn((B, n, n), generator=gen, device=dev)
        x = torch.randn((B, n), generator=gen, device=dev)
        y = gemv.batched_gemv(A, x)
        err = rel_err(y, gemv_f64(A, x))
        print(f"gemv f32 B={B} n={n}: rel err {err:.3e}")
        require(err < GEMV_F32_TOL, f"f32 gemv (B={B}, n={n}) rel err {err}")
        Ab = A.to(torch.bfloat16)
        yb = gemv.batched_gemv(Ab, x)
        err = rel_err(yb, gemv.batched_gemv_reference(Ab, x).double())
        print(f"gemv bf16 B={B} n={n}: rel err vs plain bf16 {err:.3e}")
        require(err < GEMV_BF16_PLAIN_TOL, f"bf16 gemv (B={B}, n={n}) rel err {err}")
        if n != 37:
            check_offsets(f"gemv f32 B={B} n={n}", A, x, y)
            check_offsets(f"gemv bf16 B={B} n={n}", Ab, x, yb)
        del A, x, y, Ab, yb

    B, n = B_ITER, N
    A = torch.randn((B, n, n), generator=gen, device=dev)
    x = torch.randn((B, n), generator=gen, device=dev)
    ref = gemv_f64(A, x)
    y = gemv.batched_gemv(A, x)
    f32_err = rel_err(y, ref)
    f32_abs = float((y.double() - ref).abs().max())
    print(f"gemv f32 B={B} n={n}: rel err {f32_err:.3e}, max abs err {f32_abs:.3e}")
    require(f32_err < GEMV_F32_TOL, f"f32 gemv rel err {f32_err}")
    Ab = A.to(torch.bfloat16)
    bf16_err = rel_err(gemv.batched_gemv(Ab, x), ref)
    bf16_plain_err = rel_err(gemv.batched_gemv(Ab, x),
                             gemv.batched_gemv_reference(Ab, x).double())
    print(f"gemv bf16 B={B} n={n}: rel err vs f64 of f32 A {bf16_err:.3e}, "
          f"vs plain bf16 {bf16_plain_err:.3e}")
    require(bf16_err < GEMV_BF16_TOL, f"bf16 gemv rel err {bf16_err}")
    require(bf16_plain_err < GEMV_BF16_PLAIN_TOL, f"bf16 gemv vs plain {bf16_plain_err}")
    del ref
    require(gemv.LAUNCHES > before, "the kernel checks launched no kernel")

    yb = gemv.batched_gemv(Ab, x)
    bf16_abs = float((yb.double() - chunked_f64(gemv.batched_gemv_reference, Ab,
                                                x.to(torch.bfloat16))).abs().max())
    del yb
    ms = device_ms(lambda: gemv.batched_gemv(A, x))
    host_ms = host_inclusive_ms(lambda: gemv.batched_gemv(A, x))
    plain_ms = device_ms(lambda: gemv.batched_gemv_reference(A, x))
    # One PyTorch call for the same function (cuBLAS); the port never calls
    # it.  For bf16 A, x is rounded to bf16 outside the clock, and
    # ``out_dtype`` sums the bf16 products in f32 into an f32 y.
    library_ms = device_ms(lambda: torch.bmm(A, x.unsqueeze(-1)))
    xb = x.to(torch.bfloat16).unsqueeze(-1)
    y_lib = torch.bmm(Ab, xb, out_dtype=torch.float32).squeeze(-1)
    lib_err = rel_err(y_lib, gemv.batched_gemv_reference(Ab, x).double())
    print(f"gemv bf16 B={B} n={n}: torch.bmm(out_dtype=float32) rel err vs plain bf16 "
          f"{lib_err:.3e}")
    require(y_lib.dtype == torch.float32 and lib_err < GEMV_BF16_PLAIN_TOL,
            f"torch.bmm bf16 -> f32 is not the bf16 GEMV's function: rel err {lib_err}")
    del y_lib
    library_bf16 = device_ms(lambda: torch.bmm(Ab, xb, out_dtype=torch.float32))
    ms_bf16 = device_ms(lambda: gemv.batched_gemv(Ab, x))
    plain_ms_bf16 = device_ms(lambda: gemv.batched_gemv_reference(Ab, x))
    f32_bytes, bf16_bytes = B * n * n * 4, B * n * n * 2
    print(f"gemv f32 (B={B}, n={n}): kernel {ms:.4f} ms "
          f"({f32_bytes / ms / 1e6:.1f} GB/s; host-inclusive {host_ms:.4f} ms), plain einsum "
          f"{plain_ms:.4f} ms ({f32_bytes / plain_ms / 1e6:.1f} GB/s)")
    print(f"gemv bf16 (B={B}, n={n}): kernel {ms_bf16:.4f} ms "
          f"({bf16_bytes / ms_bf16 / 1e6:.1f} GB/s), plain (upcast + einsum) "
          f"{plain_ms_bf16:.4f} ms")
    bound_ms, bound_by = gemv_bound(A, x)
    bound_bf16, by_bf16 = gemv_bound(Ab, x)
    print(f"gemv f32 (B={B}, n={n}): torch.bmm {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}); bf16: torch.bmm(out_dtype=float32) {library_bf16:.4f} ms, "
          f"bound {bound_bf16:.4f} ms ({by_bf16})")
    return {"max_abs_err": f32_abs, "ms": ms, "host_inclusive_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "bf16": {"max_abs_err": bf16_abs, "ms": ms_bf16, "plain_ms": plain_ms_bf16,
                     "bound_ms": bound_bf16, "bound_by": by_bf16,
                     "library_ms": library_bf16}}


def check_kernel_f64(gen, dev):
    """The GEMV's f64 instance against the plain f64 version on the card
    (rel err <= GEMV_F64_TOL, two launches bitwise equal, bitwise at the
    storage offsets GEMV_OFFSETS with NaN around A and x); returns its
    measurements at the rung's shape (B_F64, N)."""
    before = gemv.LAUNCHES_F64
    for B, n in ((3, 999), (3, 37), (B_F64, N)):
        A = torch.randn((B, n, n), generator=gen, device=dev, dtype=torch.float64)
        x = torch.randn((B, n), generator=gen, device=dev, dtype=torch.float64)
        y = gemv.batched_gemv(A, x)
        require(y.dtype == torch.float64, f"f64 gemv returned {y.dtype}")
        require(torch.equal(bits(gemv.batched_gemv(A, x)), bits(y)),
                f"f64 gemv (B={B}, n={n}): two launches differ")
        ref = gemv.batched_gemv_reference(A, x)
        err = rel_err(y, ref)
        print(f"gemv f64 B={B} n={n}: rel err vs plain f64 {err:.3e}")
        require(err <= GEMV_F64_TOL, f"f64 gemv (B={B}, n={n}) rel err {err}")
        if (B, n) == (B_F64, N):
            ms = device_ms(lambda: gemv.batched_gemv(A, x))
            host_ms = host_inclusive_ms(lambda: gemv.batched_gemv(A, x))
            plain_ms = device_ms(lambda: gemv.batched_gemv_reference(A, x))
            library_ms = device_ms(lambda: torch.bmm(A, x.unsqueeze(-1)))
            library_host_ms = host_inclusive_ms(lambda: torch.bmm(A, x.unsqueeze(-1)))
            bound_ms, bound_by = gemv_bound(A, x)
            nbytes = A.numel() * 8
            print(f"gemv f64 (B={B}, n={n}): kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s; "
                  f"host-inclusive {host_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.bmm "
                  f"{library_ms:.4f} ms (host-inclusive {library_host_ms:.4f} ms); bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
            measured = {"B": B, "n": n, "max_abs_err": float((y - ref).abs().max()),
                        "max_rel_err": err, "ms": ms, "host_inclusive_ms": host_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "library_host_inclusive_ms": library_host_ms}
        if n != 37:
            check_offsets(f"gemv f64 B={B} n={n}", A, x, y)
    require(gemv.LAUNCHES_F64 > before, "the f64 checks launched no f64 GEMV")
    return measured


def gemv_pairs(gen, dev):
    """The GEMV kernel against its plain version (``einsum``; for bf16 A the
    upcast and ``einsum``) at PAIR_SHAPES: PAIR_ROUNDS interleaved rounds,
    each the kernel then the plain version (for f64 then ``torch.bmm``,
    cuBLAS, too), each ``device_ms``.  Returns one record per shape: the
    medians over the rounds, GB/s of A, and the min / median / max of the
    per-round ratio kernel / plain (and kernel / ``torch.bmm``)."""
    pairs = []
    for B, n, dtype in PAIR_SHAPES:
        A = torch.randn((B, n, n), generator=gen, device=dev).to(dtype)
        x = torch.randn((B, n), generator=gen, device=dev)
        if dtype == torch.float64:
            x = x.double()
        kern, plain, lib = [], [], []
        for _ in range(PAIR_ROUNDS):
            kern.append(device_ms(lambda: gemv.batched_gemv(A, x)))
            plain.append(device_ms(lambda: gemv.batched_gemv_reference(A, x)))
            if dtype == torch.float64:
                lib.append(device_ms(lambda: torch.bmm(A, x.unsqueeze(-1))))
        ratios = sorted(k / p for k, p in zip(kern, plain))
        nbytes = A.numel() * A.element_size()
        ms, plain_ms = statistics.median(kern), statistics.median(plain)
        rec = {"B": B, "n": n, "dtype": str(dtype).removeprefix("torch."),
               "rounds": PAIR_ROUNDS, "ms": ms, "plain_ms": plain_ms,
               "gbps": nbytes / ms / 1e6, "plain_gbps": nbytes / plain_ms / 1e6,
               "ratio_min": ratios[0], "ratio_median": statistics.median(ratios),
               "ratio_max": ratios[-1]}
        line = (f"gemv pairs {rec['dtype']} (B={B}, n={n}), {PAIR_ROUNDS} rounds: kernel "
                f"{ms:.4f} ms ({rec['gbps']:.1f} GB/s), plain {plain_ms:.4f} ms "
                f"({rec['plain_gbps']:.1f} GB/s); kernel / plain min {ratios[0]:.4f}, "
                f"median {rec['ratio_median']:.4f}, max {ratios[-1]:.4f}")
        if lib:
            lratios = sorted(k / q for k, q in zip(kern, lib))
            rec.update(library_ms=statistics.median(lib),
                       library_gbps=nbytes / statistics.median(lib) / 1e6,
                       library_ratio_min=lratios[0],
                       library_ratio_median=statistics.median(lratios),
                       library_ratio_max=lratios[-1])
            line += (f"; torch.bmm {rec['library_ms']:.4f} ms ({rec['library_gbps']:.1f} GB/s), "
                     f"kernel / torch.bmm min {lratios[0]:.4f}, median "
                     f"{rec['library_ratio_median']:.4f}, max {lratios[-1]:.4f}")
        print(line)
        pairs.append(rec)
        del A, x
        torch.cuda.empty_cache()
    return pairs


def check_bounds(As, L, mu):
    """The prep's (L, mu) on BOUND_LANES lanes: against the plain f64
    version of the same algorithm (on the CPU, since the kernel takes f32),
    and against the ends of the spectrum from f64 eigvalsh.  The algorithm
    does not certify its bounds, so the second check is a band, and the
    margins are printed."""
    A64 = As[:BOUND_LANES].double()
    L64, mu64 = estimate_spectral_bounds(A64.cpu())
    L, mu = L[:BOUND_LANES].double().cpu(), mu[:BOUND_LANES].double().cpu()
    err_L = float(((L - L64).abs() / L64).max())
    err_mu = float(((mu - mu64).abs() / mu64).max())
    print(f"cone prep: f32 kernel bounds vs plain f64 on {BOUND_LANES} lanes: "
          f"L rel err {err_L:.3e}, mu rel err {err_mu:.3e}")
    require(err_L < BOUND_TOL and err_mu < BOUND_TOL,
            f"spectral bounds: rel err L {err_L}, mu {err_mu} against the f64 plain version")
    w = torch.linalg.eigvalsh(A64).cpu()
    r_L, r_mu = L / w[:, -1], mu / w[:, 0]
    print(f"cone prep vs eigvalsh: L / lambda_max in [{float(r_L.min()):.5f}, "
          f"{float(r_L.max()):.5f}] (L >= lambda_max on {int((r_L >= 1).sum())} of "
          f"{BOUND_LANES} lanes); mu / lambda_min in [{float(r_mu.min()):.5f}, "
          f"{float(r_mu.max()):.5f}] (mu <= lambda_min on {int((r_mu <= 1).sum())} of "
          f"{BOUND_LANES} lanes)")
    require(bool(((r_L - 1).abs() < SPECTRUM_TOL).all() & ((r_mu - 1).abs() < SPECTRUM_TOL).all()),
            f"spectral bounds off the spectrum by more than {SPECTRUM_TOL}: "
            f"L / lambda_max {r_L.tolist()}, mu / lambda_min {r_mu.tolist()}")


def symmetric_batch(gen, dev, B, n, chunk=256):
    """A = G + G^T, G standard normal, built in lane chunks."""
    A = torch.empty((B, n, n), device=dev)
    for i in range(0, B, chunk):
        G = torch.randn((min(chunk, B - i), n, n), generator=gen, device=dev)
        torch.add(G, G.mT, out=A[i:i + chunk])
    return A


def bits(y):
    return y.contiguous().view(torch.int32)


def check_entry(name, fn, ref):
    """Kernel entry point against its f64 plain version, and bitwise
    repeatable over two launches.  Returns (y, rel err, max abs err)."""
    y = fn()
    y2 = fn()
    require(torch.equal(bits(y), bits(y2)), f"{name}: two launches differ")
    require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = rel_err(y, ref)
    require(err < SYMV_TOL, f"{name}: rel err {err}")
    return y, err, float((y.double() - ref).abs().max())


def symv_pairs(Ap1, x1, n, slices):
    """``symv_packed`` on one problem at ``slices`` row slices against one
    slice: SYMV_PAIR_ROUNDS interleaved rounds, the order alternating, each
    ``device_ms``.  Returns the medians and the min / median / max of the
    per-round ratio."""
    runs = {slices: [], 1: []}
    for k in range(SYMV_PAIR_ROUNDS):
        for S in ((slices, 1) if k % 2 == 0 else (1, slices)):
            runs[S].append(device_ms(lambda: symv.symv_packed(Ap1, x1, n, slices=S)))
    ratios = sorted(a / b for a, b in zip(runs[slices], runs[1]))
    return {"ms": statistics.median(runs[slices]), "ms_s1": statistics.median(runs[1]),
            "rounds": SYMV_PAIR_ROUNDS, "ratio_min": ratios[0],
            "ratio_median": statistics.median(ratios), "ratio_max": ratios[-1]}


def check_symv(gen, dev, floor_ms):
    """The three symv entry points against their plain versions on the
    card, at the row slices ``symv.row_slices`` picks and at one slice;
    returns the measurements of each at the packed mode's shape (the
    single-problem wrapper at its lane 0), with the launches this check
    made of each."""
    before = dict(symv.LAUNCHES)
    sms = symv.sm_count(dev.index)
    measured = {}
    for B, n, tile in SYMV_SHAPES:
        A = symmetric_batch(gen, dev, B, n)
        x = torch.randn((B, n), generator=gen, device=dev)
        Ap = symv.pack_symmetric(A, tile)
        T = Ap.shape[1]
        S_many, S_one = symv.row_slices(B, T, tile, sms), symv.row_slices(1, T, tile, sms)
        tag = f"B={B} n={n} tile={tile}"
        ref_full = chunked_f64(lambda a, v: symv.batched_symv_reference(a, v, tile), A, x)
        ref_pack = chunked_f64(lambda a, v: symv.batched_symv_packed_reference(a, v, n), Ap, x)
        ref_one = symv.symv_packed_reference(Ap[0].double(), x[0].double(), n)
        y_full, err_full, abs_full = check_entry(
            f"batched_symv {tag}", lambda: symv.batched_symv(A, x, tile), ref_full)
        y_pack, err_pack, abs_pack = check_entry(
            f"batched_symv_packed {tag}", lambda: symv.batched_symv_packed(Ap, x), ref_pack)
        y_one, err_one, abs_one = check_entry(
            f"symv_packed n={n} tile={tile}", lambda: symv.symv_packed(Ap[0], x[0]), ref_one)
        # One slice (the kernel before slices) against the same references.
        y1_full, err1_full, _ = check_entry(
            f"batched_symv {tag} S=1", lambda: symv.batched_symv(A, x, tile, slices=1), ref_full)
        y1_pack, err1_pack, _ = check_entry(
            f"batched_symv_packed {tag} S=1", lambda: symv.batched_symv_packed(Ap, x, slices=1),
            ref_pack)
        _, err1_one, _ = check_entry(
            f"symv_packed n={n} tile={tile} S=1",
            lambda: symv.symv_packed(Ap[0], x[0], slices=1), ref_one)
        print(f"symv {tag}: row slices {S_many} (B={B}, {B * T * S_many} blocks), {S_one} (B=1, "
              f"{T * S_one} blocks); rel err full {err_full:.3e}, packed {err_pack:.3e}, "
              f"single {err_one:.3e}; at S=1 {err1_full:.3e}, {err1_pack:.3e}, {err1_one:.3e}")
        if S_many == 1:
            require(torch.equal(bits(y1_full), bits(y_full)) and
                    torch.equal(bits(y1_pack), bits(y_pack)),
                    f"symv {tag}: S=1 picked, yet forced S=1 differs")
            print(f"symv {tag}: S=1 picked; bitwise equal to forced S=1 (full and packed)")
        if (B, n, tile) == SYMV_SHAPES[-1]:
            # One PyTorch call gives the full layout's y: torch.bmm over the
            # whole stack (it reads the lower tiles too), timed before they
            # turn NaN below.
            y_bmm = torch.bmm(A, x.unsqueeze(-1))[..., 0]
            err_bmm = rel_err(y_bmm, ref_full)
            require(err_bmm < SYMV_TOL, f"torch.bmm {tag}: rel err {err_bmm}")
            library_full = device_ms(lambda: torch.bmm(A, x.unsqueeze(-1)))
            print(f"symv full layout ({tag}): torch.bmm over the whole stack {library_full:.4f} "
                  f"ms device-only, rel err {err_bmm:.3e}")
            del y_bmm
        # The strictly-lower off-diagonal tiles of the full layout are never
        # read: NaN there leaves the output bitwise the same.
        for i in range(n // tile):
            A[:, (i + 1) * tile:, i * tile:(i + 1) * tile] = torch.nan
        y_nan = symv.batched_symv(A, x, tile)
        require(torch.equal(bits(y_nan), bits(y_full)),
                f"batched_symv {tag}: output changed with NaN lower tiles")
        del ref_full, ref_pack, y1_full, y1_pack
        if (B, n, tile) != SYMV_SHAPES[-1]:
            continue
        require(S_many == 1, f"symv {tag}: row_slices picked {S_many}, not 1, at B={B}")
        packed_bytes = Ap.numel() * 4
        ms_pack = device_ms(lambda: symv.batched_symv_packed(Ap, x))
        host_pack = host_inclusive_ms(lambda: symv.batched_symv_packed(Ap, x))
        plain_pack = device_ms(lambda: symv.batched_symv_packed_reference(Ap, x, n))
        ms_full = device_ms(lambda: symv.batched_symv(A, x, tile))
        plain_full = device_ms(lambda: symv.batched_symv_reference(A, x, tile))
        for label, ms, plain in (("packed", ms_pack, plain_pack),
                                 ("full layout", ms_full, plain_full)):
            print(f"symv {label} ({tag}, {packed_bytes / 1e9:.3f} GB of tiles): "
                  f"kernel {ms:.4f} ms ({packed_bytes / ms / 1e6:.1f} GB/s), "
                  f"plain {plain:.4f} ms ({packed_bytes / plain / 1e6:.1f} GB/s)")
        print(f"symv packed ({tag}): host-inclusive {host_pack:.4f} ms")
        # Each reads the upper tiles once, x once, writes y once; 2 FLOPs
        # per element of the symmetric A.  No single PyTorch call reads only
        # the upper tiles: the packed layouts have no library time, the full
        # one torch.bmm's over the whole stack (above).  The tiles of one
        # problem (2.6 MB) stay in the 50 MB L2 from rep to rep, as they do
        # from matvec to matvec in mode (l), so its bound is not a floor.
        io = 2 * B * n * 4
        b_many = bound(packed_bytes + io, 2 * B * n * n)
        b_one = bound(packed_bytes // B + io // B, 2 * n * n)
        Ap1, x1 = Ap[0], x[0]
        one = symv_pairs(Ap1, x1, n, S_one)
        host_one = host_inclusive_ms(lambda: symv.symv_packed(Ap1, x1))
        plain_one = device_ms(lambda: symv.symv_packed_reference(Ap1, x1, n))
        print(f"symv pairs: symv_packed (B=1, n={n}, tile={tile}), {SYMV_PAIR_ROUNDS} rounds: "
              f"S={S_one} ({T * S_one} blocks) {one['ms']:.4f} ms against S=1 ({T} blocks) "
              f"{one['ms_s1']:.4f} ms; S={S_one} / S=1 min {one['ratio_min']:.4f}, median "
              f"{one['ratio_median']:.4f}, max {one['ratio_max']:.4f}; launch floor "
              f"{floor_ms:.4f} ms, bound {b_one[0]:.5f} ms ({b_one[1]}); host-inclusive "
              f"{host_one:.4f} ms; plain {plain_one:.4f} ms")
        measured = {
            "batched_symv": {"max_abs_err": abs_full, "ms": ms_full, "plain_ms": plain_full,
                             "slices": S_many},
            "batched_symv_packed": {"max_abs_err": abs_pack, "ms": ms_pack,
                                    "host_inclusive_ms": host_pack, "plain_ms": plain_pack,
                                    "slices": S_many},
            "symv_packed": {"max_abs_err": abs_one, "plain_ms": plain_one,
                            "host_inclusive_ms": host_one, "slices": S_one, **one},
        }
        for name, (bms, by) in (("batched_symv", b_many), ("batched_symv_packed", b_many),
                                ("symv_packed", b_one)):
            measured[name].update(bound_ms=bms, bound_by=by, library_ms=None, floor_ms=floor_ms)
        measured["batched_symv"]["library_ms"] = library_full
        del y_full, y_pack, y_one, y_nan
    for name, m in measured.items():
        m["kernel_phase_launches"] = symv.LAUNCHES[name] - before[name]
        require(m["kernel_phase_launches"] > 0, f"the symv checks launched no {name}")
    return measured


def launch_floor(dev):
    """The device time of a minimal launch: an in-place add on a
    one-element tensor.  Printed with its host-inclusive reading."""
    one = torch.zeros(1, device=dev)
    ms = device_ms(lambda: one.add_(1))
    print(f"launch floor (in-place add on one element): device-only {ms:.4f} ms, "
          f"host-inclusive {host_inclusive_ms(lambda: one.add_(1)):.4f} ms")
    return ms


def rr_pairs(runs, bs, gen, proj):
    """Plain PCG and rr-PCG from x = 0 in RR_ROUNDS interleaved rounds, each
    round on one freshly perturbed b, the order alternating between rounds;
    prints the median wall of each and the min / median / max of the
    per-round ratio rr-PCG / plain PCG."""
    walls = {name: [] for name, _, _ in runs}
    for k in range(RR_ROUNDS):
        b = bs + NOISE * torch.randn(bs.shape, generator=gen, device=bs.device)
        for name, op_rr, cfg_rr in (runs if k % 2 == 0 else runs[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = pcg.solve(op_rr, b, proj=proj, config=cfg_rr)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            require(bool(r.converged.all()), f"{name}: a paired call did not converge")
    ratios = sorted(q / p for q, p in zip(walls["rr-PCG"], walls["plain PCG"]))
    print(f"rr pairs ({RR_ROUNDS} rounds, B={bs.shape[0]}): plain PCG median "
          f"{statistics.median(walls['plain PCG']):.5f} s, rr-PCG median "
          f"{statistics.median(walls['rr-PCG']):.5f} s; rr-PCG / plain PCG min "
          f"{ratios[0]:.4f}, median {statistics.median(ratios):.4f}, max {ratios[-1]:.4f}; "
          f"walls {json.dumps({k: [round(w, 5) for w in v] for k, v in walls.items()})}")


def check_mode(name, r, As, b, x_true=None, tol=TOL, proj64=None):
    """Convergence, residual audit and (optionally) the known optimum."""
    require(r.x.shape == b.shape and bool(torch.isfinite(r.x).all()),
            f"{name}: non-finite or misshapen solution")
    conv = float(r.converged.float().mean())
    require(conv == 1.0, f"{name}: convergence {conv} != 1.0")
    res = float(audit_residual(As, b, r.x, proj64).max())
    require(res <= tol * 1.05, f"{name}: audited residual {res} above tol")
    if x_true is not None:
        # Unperturbed b: the optimum x_uncon is interior, and a residual of
        # 2e-5 bounds |x - x*| by 3 n tol / lambda_min(A) = 6e-5.
        err = float((r.x - x_true).abs().max())
        require(err < 1e-3, f"{name}: max |x - x*| = {err}")
    return res


def run_mode(name, run, As, bs, x_uncon, gen, sweep_bytes, sweeps_floor, count,
             tol=TOL, proj64=None):
    """Warm-up on the unperturbed batch, then REPS timed perturbed calls.
    ``count()`` reads the launch count of the kernel that carries the mode's
    matvecs.  Returns the warm-up call's result and its launches."""
    B = bs.shape[0]
    before = count()
    r = run(bs)
    torch.cuda.synchronize()
    check_mode(name, r, As, bs, x_uncon, tol, proj64)
    launches = count() - before
    max_mv = int(r.matvecs.max())
    require(launches >= max_mv,
            f"{name}: {launches} kernel launches < {max_mv} matvecs of one lane")
    last = {}

    def make_args(rep):
        last["b"] = bs + NOISE * torch.randn(bs.shape, generator=gen,
                                             device=bs.device)
        return (last["b"],)

    out = timed_run(run, reps=REPS, make_args=make_args, warmup=False,
                    implied_bytes=sweep_bytes * sweeps_floor,
                    check=lambda r_: require(bool(r_.converged.all()),
                                             f"{name}: a timed rep did not converge"))
    res = check_mode(name, out.result, As, last["b"], tol=tol, proj64=proj64)
    mv = out.result.matvecs.float()
    print(f"{name}: B={B} solves/s {B / out.wall_s:.1f} (min of {REPS} walls "
          f"{[round(w, 5) for w in out.walls]}), p50 matvecs "
          f"{float(mv.median()):.1f}, max matvecs {int(mv.max())}, "
          f"audited max residual {res:.3e}, kernel launches in warm-up call "
          f"{launches}")
    return r, launches


def main():
    t_start = time.perf_counter()
    require(torch.cuda.is_available(), "no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.load()
    print(f"kernel build {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    floor_ms = launch_floor(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    measured = check_kernels(gen, dev)
    torch.cuda.empty_cache()
    # Generators of their own, so the modes' ensembles stay those of ``gen``.
    measured["f64"] = check_kernel_f64(torch.Generator(device=dev).manual_seed(SEED + 3), dev)
    torch.cuda.empty_cache()
    measured["pairs"] = gemv_pairs(torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    measured_symv = check_symv(gen, dev, floor_ms)
    torch.cuda.empty_cache()

    proj = box(-torch.ones(N), torch.ones(N), device=dev)
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)

    # ---- iterative mode ----------------------------------------------------
    iter_state = gen.get_state()   # (p) draws this ensemble again for its audit
    As, bs, x_uncon = random_qp_batch(gen, B_ITER, N, torch.float32,
                                      diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    zero_counts()
    r_dense, _ = run_mode("iterative", lambda b: run_iterative(As, b, diag, proj, cfg),
                          As, bs, x_uncon, gen, dense_sweep_bytes(B_ITER, N, 1), 10,
                          lambda: gemv.LAUNCHES)
    gemv_launches = gemv.LAUNCHES
    require(gemv_launches > 0, "the iterative mode launched no GEMV kernel")
    r_iter = r_dense   # its warm-up call on the unperturbed b, audited in (p)
    del diag

    # ---- packed mode: the same ensemble through the symv kernel -------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = SymmetricPackedDense.from_dense(As, tile=TILE_PACKED)
    torch.cuda.synchronize()
    packed_bytes = op.Ap.numel() * 4
    print(f"packed: from_dense (B={B_ITER}, n={N} -> {op.npad}, tile={TILE_PACKED}) "
          f"{time.perf_counter() - t0:.2f} s, {packed_bytes / 1e9:.3f} GB of tiles "
          f"against {As.numel() * 4 / 1e9:.3f} GB dense")
    zero_counts()
    r_packed, _ = run_mode("packed", lambda b: run_packed(op, b, proj, cfg),
                           As, bs, x_uncon, gen, packed_bytes, 10,
                           lambda: symv.LAUNCHES["batched_symv_packed"])
    # The packed operator's matvec is batched_symv_packed; the full layout
    # and the single-problem wrapper are not on this path.
    symv_launches = dict(symv.LAUNCHES)
    require(symv_launches["batched_symv_packed"] > 0,
            "the packed mode launched no batched_symv_packed kernel")
    require(symv_launches["batched_symv"] == symv_launches["symv_packed"] == 0,
            f"the packed mode launched another symv entry: {symv_launches}")
    require(gemv.LAUNCHES == 0, "the packed mode launched the dense GEMV kernel")
    differ = int((r_packed.matvecs != r_dense.matvecs).sum())
    print(f"packed: {differ} of {B_ITER} lanes differ in matvec count from the "
          f"dense iterative warm-up call")
    del op, r_dense, r_packed
    torch.cuda.empty_cache()

    # ---- (l) single request, packed: lane 0 of the same ensemble alone -----
    op1 = SymmetricPackedDense.from_dense(As[:1], tile=TILE_PACKED)
    zero_counts()
    r_one, _ = run_mode("single packed", lambda b: run_single(op1, b, proj, cfg),
                        As[:1], bs[:1], x_uncon[:1], gen, op1.Ap.numel() * 4, 10,
                        lambda: symv.LAUNCHES["symv_packed"])
    single_launches = dict(symv.LAUNCHES)
    require(single_launches["symv_packed"] > 0, "mode (l) launched no symv_packed kernel")
    require(single_launches["batched_symv_packed"] == single_launches["batched_symv"] == 0,
            f"mode (l) launched a batched symv entry: {single_launches}")
    require(gemv.LAUNCHES == 0, "mode (l) launched the dense GEMV kernel")
    print(f"single packed (l): iterations {int(r_one.iterations[0])}, matvecs "
          f"{int(r_one.matvecs[0])} in the warm-up call; symv launches over the warm-up and "
          f"timed calls {single_launches}; the wall is host-bound (the solver's small kernels "
          f"around each symv), not a kernel measurement")
    del op1, r_one

    # ---- (e) bbpgd_f: the README quick start on the same ensemble ----------
    diag = As.diagonal(dim1=-2, dim2=-1)
    cfg_bb = BBPGDfConfig(tol=TOL, max_matvecs=BUDGET)
    zero_counts()
    run_mode("bbpgd_f", lambda b: run_bbpgd_f(As, b, diag, proj, cfg_bb),
             As, bs, x_uncon, gen, dense_sweep_bytes(B_ITER, N, 1), SWEEPS_BB,
             lambda: gemv.LAUNCHES)
    require(gemv.LAUNCHES > 0, "the bbpgd_f mode launched no GEMV kernel")
    require(gemv.LAUNCHES_BF16 == 0, "the bbpgd_f mode launched the bf16 GEMV")
    require(not any(symv.LAUNCHES.values()), "the bbpgd_f mode launched a symv kernel")
    gemv_launches += gemv.LAUNCHES

    # ---- (f) mixed: the bf16 -> f32 ladder on the same ensemble ------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    As, As16 = prepare_dense_batch(As, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"mixed: prep prepare_dense_batch (B={B_ITER}, n={N}, bf16 copy "
          f"{As16.numel() * 2 / 1e9:.3f} GB) {time.perf_counter() - t0:.3f} s")
    mixed_bytes = (dense_sweep_bytes(B_ITER, N, SWEEPS_MIXED_BF16, 2)
                   + dense_sweep_bytes(B_ITER, N, SWEEPS_MIXED_F32, 4))
    zero_counts()
    r_mixed, _ = run_mode("mixed", lambda b: run_mixed(As, As16, b, diag, proj, cfg_bb),
                          As, bs, x_uncon, gen, mixed_bytes, 1, lambda: gemv.LAUNCHES)
    mixed_counts = (gemv.LAUNCHES, gemv.LAUNCHES_BF16)
    require(gemv.LAUNCHES_BF16 > 0, "the mixed mode launched no bf16 GEMV")
    require(gemv.LAUNCHES - gemv.LAUNCHES_BF16 > 0, "the mixed mode launched no f32 GEMV")
    require(not any(symv.LAUNCHES.values()), "the mixed mode launched a symv kernel")
    gemv_launches += gemv.LAUNCHES
    gemv_launches_bf16 = gemv.LAUNCHES_BF16
    print(f"mixed: GEMV launches {mixed_counts[0]} ({mixed_counts[1]} bf16, "
          f"{mixed_counts[0] - mixed_counts[1]} f32) over the warm-up and timed calls")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ra = run_phase_a(As16, bs, diag, proj, cfg_bb)
    torch.cuda.synchronize()
    print(f"mixed: phase A alone, one call {time.perf_counter() - t0:.4f} s")
    mv_a, mv = ra.matvecs.float(), r_mixed.matvecs.float()
    print(f"mixed: per lane, phase A matvecs p50 {float(mv_a.median()):.1f} max "
          f"{int(mv_a.max())}, its own (bf16) residual p50 {float(ra.residual.median()):.3e} "
          f"min {float(ra.residual.min()):.3e} against phase_a_tol {PHASE_A_TOL} (share "
          f"converged {float(ra.converged.float().mean())}); whole call p50 "
          f"{float(mv.median()):.1f} max {int(mv.max())}")
    del ra, r_mixed

    # ---- rr-PCG on MixedPrecDense: a check, then interleaved pairs ---------
    rr = {}
    rr_runs = (("plain PCG", As, PCGConfig(tol=TOL, max_matvecs=BUDGET)),
               ("rr-PCG", MixedPrecDense(As, As16),
                PCGConfig(tol=TOL, max_matvecs=BUDGET, refresh_every=REFRESH_EVERY)))
    for name, op_rr, cfg_rr in rr_runs:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pcg.solve(op_rr, bs, proj=proj, config=cfg_rr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = check_mode(name, r, As, bs, x_uncon)
        mv = r.matvecs.float()
        rr[name] = (gemv.LAUNCHES, gemv.LAUNCHES_BF16)
        print(f"{name} from x = 0 (B={B_ITER}): one call {wall:.4f} s, p50 matvecs "
              f"{float(mv.median()):.1f}, max {int(mv.max())}, audited max residual "
              f"{res:.3e}, GEMV launches {rr[name][0]} ({rr[name][1]} bf16)")
        gemv_launches += gemv.LAUNCHES
        gemv_launches_bf16 += gemv.LAUNCHES_BF16
    require(rr["rr-PCG"][1] > 0 and rr["rr-PCG"][0] > rr["rr-PCG"][1],
            f"rr-PCG launched bf16 and f32 GEMVs {rr['rr-PCG']}")
    require(not any(symv.LAUNCHES.values()), "rr-PCG launched a symv kernel")
    zero_counts()
    rr_pairs(rr_runs, bs, gen, proj)
    gemv_launches += gemv.LAUNCHES
    gemv_launches_bf16 += gemv.LAUNCHES_BF16

    # ---- (i) classic APGD on the same ensemble -----------------------------
    cfg_apgd = APGDConfig(tol=TOL_APGD_BOX, max_matvecs=BUDGET_APGD)
    zero_counts()
    r_apgd, launches = run_mode(
        "box apgd", lambda b: run_box_apgd(As, b, diag, proj, cfg_apgd), As, bs, x_uncon,
        gen, dense_sweep_bytes(B_ITER, N, 1), SWEEPS_APGD, lambda: gemv.LAUNCHES,
        tol=TOL_APGD_BOX)
    require(gemv.LAUNCHES_BF16 == 0, "the box apgd mode launched the bf16 GEMV")
    require(not any(symv.LAUNCHES.values()), "the box apgd mode launched a symv kernel")
    print("box apgd: backtracking trials in the warm-up call: %d over all lanes (max %d "
          "a lane), %d batched trial launches" % apgd_trials(r_apgd, launches))
    gemv_launches += gemv.LAUNCHES
    del As, As16, bs, x_uncon, diag, r_apgd
    torch.cuda.empty_cache()

    # ---- direct serving mode -----------------------------------------------
    As, bs, x_uncon = random_qp_batch(gen, B_DIRECT, N, torch.float32,
                                      diag_boost=1.0, chunk=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ainv = spd_inverse_batch(As)
    torch.cuda.synchronize()
    print(f"direct: prep (batched Cholesky inverse, B={B_DIRECT}) "
          f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    run_mode("direct", lambda b: run_direct(Ainv, As, b, proj, cfg),
             As, bs, x_uncon, gen, dense_sweep_bytes(B_DIRECT, N, 1), 2,
             lambda: gemv.LAUNCHES)
    require(gemv.LAUNCHES > 0, "the direct mode launched no GEMV kernel")
    require(not any(symv.LAUNCHES.values()), "the direct mode launched a symv kernel")
    gemv_launches += gemv.LAUNCHES
    del As, bs, x_uncon, Ainv
    torch.cuda.empty_cache()

    # ---- cone mode ---------------------------------------------------------
    As, bs, _ = random_qp_batch(gen, B_CONE, N_CONE, torch.float32,
                                diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    proj_cone, proj64_cone = cone_proj(device=dev), cone_proj(torch.float64, dev)
    # The GEMV at the cone width: rows of n = 999 are not 16-byte aligned.
    x = torch.randn((B_CONE, N_CONE), generator=gen, device=dev)
    y, ref = gemv.batched_gemv(As, x), gemv_f64(As, x)
    err = rel_err(y, ref)
    require(err < GEMV_F32_TOL, f"f32 gemv (B={B_CONE}, n={N_CONE}) rel err {err}")
    gemv_999 = {"max_abs_err": float((y.double() - ref).abs().max()),
                "ms": device_ms(lambda: gemv.batched_gemv(As, x)),
                "plain_ms": device_ms(lambda: gemv.batched_gemv_reference(As, x)),
                "library_ms": device_ms(lambda: torch.bmm(As, x.unsqueeze(-1)))}
    gemv_999["bound_ms"], gemv_999["bound_by"] = gemv_bound(As, x)
    del y, ref, x
    print(f"gemv f32 (B={B_CONE}, n={N_CONE}): rel err {err:.3e}, "
          f"kernel {gemv_999['ms']:.4f} ms ({As.numel() * 4 / gemv_999['ms'] / 1e6:.1f} GB/s), "
          f"plain einsum {gemv_999['plain_ms']:.4f} ms "
          f"({As.numel() * 4 / gemv_999['plain_ms'] / 1e6:.1f} GB/s)")

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L, mu = estimate_spectral_bounds(As, iters=32)
    torch.cuda.synchronize()
    print(f"cone: prep estimate_spectral_bounds (B={B_CONE}, n={N_CONE}, 2 x 33 sweeps) "
          f"{time.perf_counter() - t0:.3f} s")
    require(gemv.LAUNCHES == 2 * 33, f"the prep launched {gemv.LAUNCHES} GEMV kernels, not 66")
    check_bounds(As, L, mu)
    sop = SpectralDense(As, L, mu)
    run_mode("cone apgd_sc", lambda b: run_cone_apgd(
                 sop, b, proj_cone, APGDSCConfig(tol=TOL_CONE, max_matvecs=BUDGET_CONE)),
             As, bs, None, gen, dense_sweep_bytes(B_CONE, N_CONE, 1), 14,
             lambda: gemv.LAUNCHES, tol=TOL_CONE, proj64=proj64_cone)
    require(not any(symv.LAUNCHES.values()), "cone run (a) launched a symv kernel")
    cone_launches = gemv.LAUNCHES
    zero_counts()
    run_mode("cone mprgp_bb", lambda b: run_cone_mprgp(
                 As, b, diag, proj_cone, MPRGPBBConfig(tol=TOL_CONE, max_matvecs=BUDGET_CONE)),
             As, bs, None, gen, dense_sweep_bytes(B_CONE, N_CONE, 1), 27,
             lambda: gemv.LAUNCHES, tol=TOL_CONE, proj64=proj64_cone)
    require(not any(symv.LAUNCHES.values()), "cone run (b) launched a symv kernel")
    cone_launches += gemv.LAUNCHES

    # (g) SPG from x = 0 with per-lane keys, uncompacted, then compacted.
    keys = split_keys(SEED_SPG, B_CONE, dev)
    cfg_spg = SPGConfig(tol=TOL_CONE, max_matvecs=BUDGET_CONE, criterion="eq25")
    zero_counts()
    r_spg, _ = run_mode("cone spg", lambda b: run_cone_spg(As, b, proj_cone, cfg_spg, keys),
                        As, bs, None, gen, dense_sweep_bytes(B_CONE, N_CONE, 1), SWEEPS_SPG,
                        lambda: gemv.LAUNCHES, tol=TOL_CONE, proj64=proj64_cone)
    phase1 = 2 * int(r_spg.matvecs.float().median())
    before = gemv.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_cone_spg_compact(As, bs, proj_cone, cfg_spg, keys, phase1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = check_mode("cone spg compacted", r, As, bs, tol=TOL_CONE, proj64=proj64_cone)
    in_phase2 = int((r.matvecs > phase1).sum())
    launches = gemv.LAUNCHES - before
    require(in_phase2 >= 1, f"cone spg compacted: no lane reached phase 2 at phase 1 {phase1}")
    require(launches >= int(r.matvecs.max()),
            f"cone spg compacted: {launches} GEMV launches < {int(r.matvecs.max())} matvecs")
    mv = r.matvecs.float()
    print(f"cone spg compacted: one call {wall:.4f} s, phase 1 at {phase1} (2 x the first "
          f"call's p50), {in_phase2} of {B_CONE} lanes in phase 2 ({in_phase2 / B_CONE:.4f}), "
          f"p50 matvecs {float(mv.median()):.1f}, max {int(mv.max())}, audited max residual "
          f"{res:.3e}, GEMV launches {launches}")
    require(not any(symv.LAUNCHES.values()), "cone spg launched a symv kernel")
    cone_launches += gemv.LAUNCHES
    del r_spg, r

    # (h) APGD-AR from the cone-Jacobi start.
    cfg_ar = APGDConfig(tol=TOL_CONE, max_matvecs=BUDGET_CONE)
    zero_counts()
    r_ar, launches = run_mode(
        "cone apgd_ar", lambda b: run_cone_apgd_ar(As, b, diag, proj_cone, cfg_ar), As, bs,
        None, gen, dense_sweep_bytes(B_CONE, N_CONE, 1), SWEEPS_APGD, lambda: gemv.LAUNCHES,
        tol=TOL_CONE, proj64=proj64_cone)
    require(not any(symv.LAUNCHES.values()), "cone apgd_ar launched a symv kernel")
    print("cone apgd_ar: backtracking trials in the warm-up call: %d over all lanes (max %d "
          "a lane), %d batched trial launches" % apgd_trials(r_ar, launches))
    cone_launches += gemv.LAUNCHES
    print(f"cone: GEMV launches {cone_launches} (prep, every run's warm-up and timed calls)")
    gemv_launches += cone_launches
    del As, bs, diag, r_ar
    torch.cuda.empty_cache()

    # ---- the README's quick start: SPG at B=1 ------------------------------
    A3, b3, proj3 = readme_qp(dev)
    zero_counts()
    r = spg.solve(A3, b3, proj=proj3, config=SPGConfig(tol=1e-6, max_matvecs=5000))
    torch.cuda.synchronize()
    err = float((r.x - torch.tensor([[1., 0., 1.]], device=dev)).abs().max())
    require(bool(r.converged.all()) and err < 1e-4,
            f"README quick start: converged {r.converged.tolist()}, max |x - x*| {err}")
    require(gemv.LAUNCHES >= int(r.matvecs.max()) and not any(symv.LAUNCHES.values()),
            f"README quick start: {gemv.LAUNCHES} GEMV launches for {int(r.matvecs.max())} "
            f"matvecs")
    print(f"README quick start (spg.solve, B=1, n=3): x {r.x[0].tolist()}, matvecs "
          f"{int(r.matvecs[0])}, residual {float(r.residual[0]):.3e}, max |x - x*| {err:.3e}, "
          f"GEMV launches {gemv.LAUNCHES}")
    gemv_launches += gemv.LAUNCHES

    # ---- (j) the f64-exact rung, and plain f64 PCG beside it ---------------
    gen64 = torch.Generator(device=dev).manual_seed(SEED + 2)
    As, bs, _ = random_qp_batch(gen64, B_F64, N, torch.float64, diag_boost=0.0)
    As32 = As.float()
    diag = As.diagonal(dim1=-2, dim2=-1)
    proj64 = box(-torch.ones(N), torch.ones(N), dtype=torch.float64, device=dev)
    cfg_rung = PCGConfig(tol=TOL_F64, max_matvecs=BUDGET_F64, refresh_every=REFRESH_F64,
                         segment_drop=SEGMENT_DROP_F64)
    rhs_state = gen64.get_state()   # plain PCG draws the same right-hand sides
    zero_counts()
    run_mode("f64 rung", lambda b: run_rung(As, As32, b, diag, proj64, cfg_rung), As, bs, None,
             gen64, dense_sweep_bytes(B_F64, N, 1), SWEEPS_RUNG, lambda: gemv.LAUNCHES,
             tol=TOL_F64, proj64=proj64)
    print(f"f64 rung: GEMV launches over the warm-up and timed calls: {f32_launches()} f32 "
          f"(cheap sweeps), {gemv.LAUNCHES_F64} f64 (refreshes), {gemv.LAUNCHES_BF16} bf16")
    require(f32_launches() > 0 and gemv.LAUNCHES_F64 > 0,
            f"the f64 rung launched {f32_launches()} f32 and {gemv.LAUNCHES_F64} f64 GEMVs")
    require(gemv.LAUNCHES_BF16 == 0, "the f64 rung launched the bf16 GEMV")
    require(not any(symv.LAUNCHES.values()), "the f64 rung launched a symv kernel")
    gemv_launches += gemv.LAUNCHES
    gemv_launches_f64 = gemv.LAUNCHES_F64

    gen64.set_state(rhs_state)
    cfg_plain64 = PCGConfig(tol=TOL_F64, max_matvecs=BUDGET_F64)
    zero_counts()
    run_mode("f64 plain pcg", lambda b: run_f64_plain(As, b, diag, proj64, cfg_plain64), As, bs,
             None, gen64, dense_sweep_bytes(B_F64, N, 1, 8), SWEEPS_F64_PLAIN,
             lambda: gemv.LAUNCHES, tol=TOL_F64, proj64=proj64)
    require(gemv.LAUNCHES_F64 == gemv.LAUNCHES > 0,
            f"plain f64 PCG launched {gemv.LAUNCHES} GEMVs, {gemv.LAUNCHES_F64} of them f64")
    require(not any(symv.LAUNCHES.values()), "plain f64 PCG launched a symv kernel")
    gemv_launches += gemv.LAUNCHES
    gemv_launches_f64 += gemv.LAUNCHES_F64

    del As, As32, bs, diag
    torch.cuda.empty_cache()

    # ---- (k) the huge block-sparse QP --------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op, b_huge, x_exact = block_tridiag_qp(N_HUGE, SEED_HUGE, device=dev)
    torch.cuda.synchronize()
    op_bytes = op.blocks.numel() * op.blocks.element_size()
    print(f"huge qp: prep block_tridiag_qp (n={N_HUGE}) {time.perf_counter() - t0:.2f} s, "
          f"operator {op_bytes / 1e6:.1f} MB")
    proj_huge = box(-torch.ones(N_HUGE), torch.ones(N_HUGE), device=dev)
    cfg_huge = PCGConfig(tol=TOL_HUGE, max_matvecs=BUDGET_HUGE)
    zero_counts()
    r = run_huge(op, b_huge, proj_huge, cfg_huge)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(r.x).all()) and r.x.shape == (1, N_HUGE),
            "huge qp: non-finite or misshapen solution")
    require(bool(r.converged.all()), "huge qp: the warm-up call did not converge")
    res = float(audit_blocksparse(op, b_huge, r.x).max())
    err = float((r.x - x_exact).norm() / x_exact.norm())
    print(f"huge qp: warm-up call (unperturbed b): matvecs {int(r.matvecs[0])}, audited residual "
          f"{res:.3e}, rel err vs x_exact {err:.3e}")
    require(res <= TOL_HUGE * 1.05, f"huge qp: audited residual {res} above tol")
    warm_k = r
    last = {}

    def huge_args(seed):
        """The timed calls' right-hand sides: b perturbed from ``seed``, the
        last one kept in ``last``."""
        gen_huge = torch.Generator(device=dev).manual_seed(seed)

        def make(rep):
            last["b"] = b_huge + NOISE_HUGE * torch.randn(b_huge.shape, generator=gen_huge,
                                                          device=dev)
            return (last["b"],)
        return make

    out = timed_run(lambda b: run_huge(op, b, proj_huge, cfg_huge), reps=REPS,
                    make_args=huge_args(SEED + 4), warmup=False,
                    implied_bytes=SWEEPS_HUGE * op_bytes,
                    check=lambda r_: require(bool(r_.converged.all()),
                                             "huge qp: a timed call did not converge"))
    out_k = out
    r = out.result
    res = float(audit_blocksparse(op, last["b"], r.x).max())
    require(res <= TOL_HUGE * 1.05, f"huge qp: audited residual {res} above tol")
    its = int(r.iterations[0])
    err = float((r.x - x_exact).norm() / x_exact.norm())
    print(f"huge qp (n={N_HUGE}, pcg, tol {TOL_HUGE}): converged, matvecs {int(r.matvecs[0])}, "
          f"iterations {its}, wall {out.wall_s:.4f} s (min of {REPS} "
          f"{[round(w, 5) for w in out.walls]}), iterations/s {its / out.wall_s:.1f}, operator "
          f"{op_bytes / 1e6:.1f} MB, rel err vs x_exact {err:.3e} (b perturbed), audited "
          f"residual {res:.3e}")
    require(gemv.LAUNCHES == 0 and not any(symv.LAUNCHES.values()),
            f"huge qp launched {gemv.LAUNCHES} GEMV and {dict(symv.LAUNCHES)} symv kernels")

    # ---- the distributed layer: world 1 over NCCL ---------------------------
    # The rendezvous and NCCL's bootstrap stay on the loopback interface.
    os.environ["NCCL_SOCKET_IFNAME"] = "lo"
    t_dist = t0 = time.perf_counter()
    rank, world = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda",
                                   timeout=DIST_TIMEOUT)
    require(dist.get_backend() == "nccl" and (rank, world) == (0, 1),
            f"init_distributed gave {dist.get_backend()} rank {rank} of {world}")
    mesh = make_mesh(axis="model")
    print(f"distributed: init_distributed (NCCL, world {world}) and make_mesh "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- (m) (k)'s QP row-sharded ----------------------------------------
    zero_counts()
    r = run_huge_sharded(op, b_huge, proj_huge, cfg_huge, mesh)
    torch.cuda.synchronize()
    counts = dict(COLLECTIVES)
    mv = int(r.matvecs[0])
    require(mv == int(warm_k.matvecs[0]),
            f"huge qp sharded: {mv} matvecs against (k)'s {int(warm_k.matvecs[0])}")
    require(torch.equal(r.x, warm_k.x), "huge qp sharded: x differs from (k)'s")
    require(counts["all_gather"] >= mv,
            f"huge qp sharded: {counts['all_gather']} NCCL all-gathers for {mv} matvecs")
    print(f"huge qp sharded (m): warm-up call matvecs {mv} and x bitwise (k)'s; "
          f"{collectives_line(counts, int(r.iterations[0]))}")
    out = timed_run(lambda b: run_huge_sharded(op, b, proj_huge, cfg_huge, mesh), reps=REPS,
                    make_args=huge_args(SEED + 4), warmup=False,
                    implied_bytes=SWEEPS_HUGE * op_bytes,
                    check=lambda r_: require(bool(r_.converged.all()),
                                             "huge qp sharded: a timed call did not converge"))
    require(torch.equal(out.result.x, out_k.result.x),
            "huge qp sharded: the last timed call's x differs from (k)'s on the same b")
    res = float(audit_blocksparse(op, last["b"], out.result.x).max())
    require(res <= TOL_HUGE * 1.05, f"huge qp sharded: audited residual {res} above tol")
    require(gemv.LAUNCHES == 0 and not any(symv.LAUNCHES.values()),
            "huge qp sharded launched a kernel of the package")
    print(f"huge qp sharded (m): wall {out.wall_s:.4f} s (min of {REPS} "
          f"{[round(w, 5) for w in out.walls]}) against (k)'s {out_k.wall_s:.4f} s on the same "
          f"b's (ratio {out.wall_s / out_k.wall_s:.4f}), x bitwise (k)'s, audited residual "
          f"{res:.3e}")
    per_call = collective_host_ms(b_huge, mesh_axis(mesh, "model")[0])
    print(f"huge qp sharded (m): wall per call over {COLLECTIVE_REPS} calls in a row: NCCL "
          f"all-gather of x (1, {N_HUGE}) f32 {per_call['all_gather']:.4f} ms, NCCL all-reduce "
          f"SUM of one value {per_call['all_reduce_sum']:.4f} ms, in-place add on one value "
          f"{per_call['add_']:.4f} ms")
    del op, b_huge, x_exact, r, out, out_k, warm_k
    torch.cuda.empty_cache()

    # ---- (n) one dense QP row-sharded ------------------------------------
    gen_n = torch.Generator(device=dev).manual_seed(SEED + 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_n, b_n, x_n = random_qp_batch(gen_n, 1, N_SHARDED, torch.float32, diag_boost=1.0)
    torch.cuda.synchronize()
    a_bytes = A_n.numel() * A_n.element_size()
    print(f"dense sharded (n): prep random_qp_batch (n={N_SHARDED}) "
          f"{time.perf_counter() - t0:.2f} s, A {a_bytes / 1e9:.3f} GB")
    group = mesh_axis(mesh, "model")[0]
    sop = ShardedDenseOperator(A_n, group)
    require(torch.equal(sop.diagonal(), A_n.diagonal(dim1=-2, dim2=-1)),
            "dense sharded: the sharded diagonal is not diag(A)")
    proj_n = box(-torch.ones(N_SHARDED), torch.ones(N_SHARDED), device=dev)
    cfg_n = PCGConfig(tol=TOL, max_matvecs=BUDGET, precond="jacobi")
    zero_counts()
    r = run_dense_sharded(A_n, b_n, proj_n, cfg_n, mesh)
    torch.cuda.synchronize()
    counts = dict(COLLECTIVES)
    require(bool(r.converged.all()) and r.x.shape == (1, N_SHARDED)
            and bool(torch.isfinite(r.x).all()), "dense sharded: the warm-up call failed")
    res = float(audit_rows(A_n, b_n, r.x).max())
    err = float((r.x - x_n).abs().max())
    require(res <= TOL * 1.05, f"dense sharded: audited residual {res} above tol")
    require(err < 1e-3, f"dense sharded: max |x - x*| = {err}")
    require(counts["all_gather"] >= int(r.matvecs[0]),
            f"dense sharded: {counts['all_gather']} all-gathers for {int(r.matvecs[0])} matvecs")
    print(f"dense sharded (n): warm-up call matvecs {int(r.matvecs[0])}, iterations "
          f"{int(r.iterations[0])}, audited residual {res:.3e}, max |x - x*| {err:.3e}; "
          f"{collectives_line(counts, int(r.iterations[0]))}")
    gen_nb = torch.Generator(device=dev).manual_seed(SEED + 6)
    last_n = {}

    def dense_args(rep):
        last_n["b"] = b_n + NOISE * torch.randn(b_n.shape, generator=gen_nb, device=dev)
        return (last_n["b"],)

    out = timed_run(lambda b: run_dense_sharded(A_n, b, proj_n, cfg_n, mesh), reps=REPS,
                    make_args=dense_args, warmup=False,
                    implied_bytes=SWEEPS_SHARDED * a_bytes,
                    check=lambda r_: require(bool(r_.converged.all()),
                                             "dense sharded: a timed call did not converge"))
    res = float(audit_rows(A_n, last_n["b"], out.result.x).max())
    require(res <= TOL * 1.05, f"dense sharded: audited residual {res} above tol")
    x_full = torch.randn((1, N_SHARDED), generator=gen_n, device=dev)
    local_ms = device_ms(lambda: sop.local_matvec(x_full))
    local_bound, local_by = bound(a_bytes + 2 * x_full.numel() * 4, 2 * A_n.numel())
    mv = int(out.result.matvecs[0])
    print(f"dense sharded (n): wall {out.wall_s:.4f} s (min of {REPS} "
          f"{[round(w, 5) for w in out.walls]}), matvecs {mv}, iterations "
          f"{int(out.result.iterations[0])}, {out.wall_s / mv * 1e3:.4f} ms a matvec, "
          f"audited residual {res:.3e}; local product (torch.matmul, (1, {N_SHARDED}, "
          f"{N_SHARDED}) f32) device-only {local_ms:.4f} ms against its bound "
          f"{local_bound:.4f} ms ({local_by}; {local_bound / local_ms:.0%}), "
          f"{a_bytes / local_ms / 1e6:.1f} GB/s")
    del A_n, b_n, x_n, sop, r, out, x_full
    torch.cuda.empty_cache()

    # ---- (o) the iterative ensemble scenario-sharded -----------------------
    As, bs, x_uncon = random_qp_batch(torch.Generator(device=dev).manual_seed(SEED + 7),
                                      B_ITER, N, torch.float32, diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    bmesh = make_batch_mesh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_ref = solve_batched("pcg", As, bs, x0=jacobi_x0(diag, bs), proj=proj, config=cfg)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_scenario_sharded(As, bs, diag, proj, cfg, bmesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, counts = gemv.LAUNCHES, dict(COLLECTIVES)
    require(launches > 0, "the scenario-sharded mode launched no GEMV kernel")
    require(not any(counts.values()), f"the scenario-sharded solve made collectives {counts}")
    require(not any(symv.LAUNCHES.values()), "the scenario-sharded mode launched a symv kernel")
    require(torch.equal(r.x, r_ref.x) and torch.equal(r.matvecs, r_ref.matvecs),
            "scenario sharded: lanes differ from solve_batched on the same inputs")
    res = check_mode("scenario sharded", r, As, bs, x_uncon)
    mv = r.matvecs.float()
    print(f"scenario sharded (o): B={B_ITER}, one call {wall:.4f} s against solve_batched's "
          f"{wall_ref:.4f} s, every lane bitwise solve_batched's (x and matvecs), p50 matvecs "
          f"{float(mv.median()):.1f}, max {int(mv.max())}, audited max residual {res:.3e}, "
          f"GEMV launches {launches}, collectives {counts}")
    gemv_launches += launches
    del As, bs, x_uncon, diag, r, r_ref
    torch.cuda.empty_cache()

    for row in scaling_probe([1]):
        print(f"scaling probe: {json.dumps(row)}")
    dist.destroy_process_group()
    print(f"distributed: (m), (n), (o) and the probe {time.perf_counter() - t_dist:.1f} s")

    # ---- (p) the reference API: oracle suite, diagnostics, harness ---------
    t_p = t0 = time.perf_counter()
    zero_counts()
    rows = run_oracle(dev)
    launches = (gemv.LAUNCHES, gemv.LAUNCHES_F64)
    require(launches[1] > 0, "the oracle suite launched no f64 GEMV")
    require(not any(symv.LAUNCHES.values()), "the oracle suite launched a symv kernel")
    mv = [r[2] for r in rows]
    print(f"reference API (p) oracle: {len(rows)} compat solves (8 solvers x 6 problems, f64, "
          f"tol {ORACLE_TOL}, and the compat example SPG at 1e-10), every one converged and "
          f"audited by check_result; max |x - x*| {max(r[3] for r in rows):.3e}, max residual "
          f"{max(r[4] for r in rows):.3e}, matvecs {sum(mv)} (max {max(mv)}), solution_time "
          f"sum {sum(r[5] for r in rows):.4f} s; {time.perf_counter() - t0:.2f} s")
    for name in dict.fromkeys(r[1] for r in rows):
        sel = [r for r in rows if r[1] == name]
        print(f"reference API (p) oracle {name}: matvecs {[r[2] for r in sel]}, solution_time "
              f"{sum(r[5] for r in sel) / sum(r[2] for r in sel) * 1e3:.4f} ms a matvec")
    print(f"reference API (p) oracle: GEMV launches {launches[0]} ({launches[1]} f64)")

    t0 = time.perf_counter()
    gen_iter = torch.Generator(device=dev)
    gen_iter.set_state(iter_state)
    As, bs, _ = random_qp_batch(gen_iter, B_ITER, N, torch.float32, diag_boost=1.0, chunk=256)
    zero_counts()
    rep = check_full_width(r_iter, As, bs, proj)
    require(gemv.LAUNCHES == 0, "check_result launched the GEMV kernel")
    print(f"reference API (p) check_result on the iterative mode's warm-up call (B={B_ITER}, "
          f"n={N}): ok {rep['ok']}, feasible {rep['feasible']}, residual_consistent "
          f"{rep['residual_consistent']}, residual_rel_err {rep['residual_rel_err']:.3e}; "
          f"{time.perf_counter() - t0:.2f} s with the ensemble's draw")
    del As, bs, r_iter
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    zero_counts()
    results = run_harness(dev)
    launches = (gemv.LAUNCHES, f32_launches())
    require(launches[1] > 0, "the harness launched no f32 GEMV")
    require(not any(symv.LAUNCHES.values()), "the harness launched a symv kernel")
    for res in results:
        for line in res.summary().splitlines():
            print(f"reference API (p) harness: {line}")
        for i, sname in enumerate(res.solver_names):
            for j, fam in enumerate(res.family_names):
                print(f"reference API (p) harness: {sname} {fam} n={res.sizes[0]} solves/s "
                      f"{1 / res.solve_time[i, j, 0].mean():.1f}, convergence "
                      f"{res.converged[i, j, 0].mean():.4f}, p50 matvecs "
                      f"{np.median(res.matvecs[i, j, 0]):.1f}, max residual "
                      f"{res.residual[i, j, 0].max():.3e}")
    print(f"reference API (p) harness: GEMV launches {launches[0]} ({launches[1]} f32); "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"reference API (p): {time.perf_counter() - t_p:.1f} s")

    # ``launches`` is each entry's count over the main path's modes: the
    # packed mode's for batched_symv_packed, mode (l)'s for symv_packed, 0
    # for batched_symv, which no mode runs; ``kernel_phase_launches``
    # counts the symv checks above, which are not part of the main path.
    symv_src = "ccqppy_tpu_torch/csrc/batched_symv.cu"
    symv_lines = {"batched_symv": 133, "batched_symv_packed": 248, "symv_packed": 292}
    path_launches = {**symv_launches, "symv_packed": single_launches["symv_packed"]}
    print(json.dumps({"kernels": [
        {"name": "batched_gemv", "route": "cuda",
         "source": "ccqppy_tpu_torch/csrc/batched_gemv.cu",
         "replaces": "ccqppy_tpu/ops/pallas_kernels.py:65",
         "launches": gemv_launches, "launches_bf16": gemv_launches_bf16,
         "launches_f64": gemv_launches_f64, **measured,
         "n999": gemv_999},
        *({"name": name, "route": "cuda", "source": symv_src,
           "replaces": f"ccqppy_tpu/ops/pallas_kernels.py:{line}",
           "launches": path_launches[name], **measured_symv[name]}
          for name, line in symv_lines.items())]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start of main")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
