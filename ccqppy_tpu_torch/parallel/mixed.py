"""The bf16 -> f32 precision ladder for batched dense QPs.

Port of ``prepare_dense_batch`` and ``solve_batched_mixed`` from
``ccqppy_tpu/parallel/mixed.py``.  Three phases, every lane in one batch:

* **A**: ``phase_a_solver`` (BBPGDf by default) on ``CastDense(As_low)``,
  a bfloat16 copy of the stack, whose sweep moves half the bytes of an f32
  one (the GEMV kernel's bf16 instance on CUDA).  Its residual is the bf16
  operator's, which floors near the bf16 error (each sweep rounds x to
  bf16), so phase A only hands a start point on;
* **B**: verified ``pcg`` on the f32 stack from phase A's iterate; its
  exact residuals decide ``converged``;
* **fixup**: the lanes phase B left unconverged are gathered and finished
  at full precision by ``fixup_solver`` (MPRGP-BB by default) through
  ``host_compact_finish``.

The JAX package's layout pinning, relayout and layout-preserving row
gathers (``_relayout_fn``, ``_gather_rows``) worked around XLA's layout
assignment on the TPU; a contiguous ``(B, n, n)`` tensor needs none of them.
"""
from __future__ import annotations

import dataclasses

import torch

from ccqppy_tpu_torch.models import SOLVERS, PCGConfig, pcg
from ccqppy_tpu_torch.ops.linop import CastDense
from ccqppy_tpu_torch.parallel.batch import host_compact_finish


def prepare_dense_batch(As, low_dtype=None):
    """A contiguous ``As`` and, when ``low_dtype`` is given, a contiguous
    copy in that dtype for phase A: ``As, As16 = prepare_dense_batch(As,
    torch.bfloat16)``.  PyTorch keeps a contiguous stack batch-major, so no
    layout is pinned and the input is not donated."""
    As = As.contiguous()
    if low_dtype is None:
        return As
    return As, As.to(low_dtype).contiguous()


def solve_batched_mixed(As, bs, proj=None, config=None, *, As_low=None,
                        x0=None, phase_a_tol=5e-3, phase_a_budget=48,
                        phase_a_solver="bbpgd_f", polish_config=None,
                        fixup=True, fixup_solver="mprgp_bb",
                        fixup_bucket_min=16):
    """Solve a batch of dense QPs through the bf16 -> f32 ladder.

    As:             (B, n, n) float32 stacked Hessians; bs (B, n).
    As_low:         a bfloat16 copy (``prepare_dense_batch``); made per call
                    when omitted.
    config:         the full-precision ``SolverConfig``: ``tol`` and
                    ``max_matvecs`` are the solve's tolerance and total
                    budget (phase A's ``phase_a_budget`` included).
    phase_a_tol:    phase A's stop tolerance on its own (bf16) residual; it
                    must sit at or above the family's bf16 floor, or phase A
                    spends its whole budget.  The default (the JAX package's)
                    is below that floor on the n=1000 Wishart box family of
                    ``chip_smoke.py``, which prints the floor in mode (f).
    polish_config:  phase B's ``PCGConfig``; by default ``config``'s tol, gd
                    and trace length on the budget phase A leaves.
    fixup:          finish the unconverged lanes with ``fixup_solver`` on a
                    fresh budget of ``config.max_matvecs`` (a documented
                    overspend: the reported matvecs include it; pass False
                    for a strict budget).
    fixup_bucket_min: accepted so that calls carry over; it has no effect.
                    The port re-solves exactly the unconverged lanes, and a
                    lane's result does not depend on the others, so there is
                    no power-of-two bucket to size.

    Returns a ``SolveResult`` whose ``matvecs`` and ``iterations`` add up
    all phases per lane; every residual and ``converged`` flag comes from a
    full-precision operator.
    """
    if config is None:
        raise ValueError("config (full-precision SolverConfig) is required")
    if As_low is None:
        As_low = As.to(torch.bfloat16)
    cfg_a = SOLVERS[phase_a_solver][1](tol=float(phase_a_tol),
                                       max_matvecs=int(phase_a_budget), gd=config.gd)
    if polish_config is None:
        budget_b = int(config.max_matvecs) - int(phase_a_budget)
        if budget_b < 4:
            raise ValueError(
                f"phase_a_budget={phase_a_budget} leaves {budget_b} < 4 matvecs for "
                f"the polish phase of a max_matvecs={config.max_matvecs} budget")
        polish_config = PCGConfig(tol=config.tol, max_matvecs=budget_b, gd=config.gd,
                                  trace_len=config.trace_len)

    ra = SOLVERS[phase_a_solver][0](CastDense(As_low), bs, x0=x0, proj=proj, config=cfg_a)
    rb = pcg.solve(As, bs, x0=ra.x, proj=proj, config=polish_config)
    result = dataclasses.replace(rb, matvecs=ra.matvecs + rb.matvecs,
                                 iterations=ra.iterations + rb.iterations)
    if not fixup:
        return result

    fn_f, cfg_cls_f = SOLVERS[fixup_solver]
    cfg_f = cfg_cls_f(tol=config.tol, max_matvecs=int(config.max_matvecs), gd=config.gd)

    def run2(A2, b2, x02, proj2, keys2):
        return fn_f(A2, b2, x0=x02, proj=proj2, config=cfg_f)

    return host_compact_finish(run2, As, bs, result, proj)
