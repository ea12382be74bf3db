"""Scenario batching with straggler compaction.

Port of ``solve_batched``, ``host_compact_finish`` and
``solve_batched_fused_compact`` from ``ccqppy_tpu/parallel/batch.py``.
The port's solvers are batched already, so ``solve_batched`` is a direct
call.  Compaction gathers the unconverged lanes (plain indexing of a raw
stack, ``take`` of an operator) and re-solves exactly those lanes: per-lane
results do not depend on the other lanes of a batch, so the JAX package's
power-of-two padding, which only bounded recompilation, is not needed.  Projection parameters are shared by
all lanes; RNG keys (the SPG solver's) are not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.models.base import SolveResult
from ccqppy_tpu_torch.ops.linop import LinearOperator


def _get_solver(solver):
    if isinstance(solver, str):
        return SOLVERS[solver][0]
    return solver


def _no_keys(keys):
    if keys is not None:
        raise NotImplementedError("per-lane RNG keys serve the SPG solver, "
                                  "which is not ported yet (ROADMAP queue 1 item 11)")


def solve_batched(solver, A, b, x0=None, proj=None, config=None, keys=None):
    """Solve a batch of QPs: A (B, n, n), b (B, n), x0 (B, n) or None.
    Returns a ``SolveResult`` with a leading lane axis on every field."""
    _no_keys(keys)
    fn = _get_solver(solver)
    kwargs = {} if config is None else {"config": config}
    return fn(A, b, x0=x0, proj=proj, **kwargs)


def _gather_A(A, idx):
    """Lanes ``idx`` of a raw (B, n, n) stack or of an operator."""
    if isinstance(A, LinearOperator):
        return A.take(idx)
    return A[idx]


def _scatter(r1, idx, r2):
    """Write lane results ``r2`` over lanes ``idx`` of ``r1``; matvec and
    iteration counts accumulate.  Re-solved lanes report their phase-2
    residual history."""
    trace = r1.trace
    if trace.shape[-1] > 0:
        trace = trace.index_copy(0, idx, r2.trace)
    return SolveResult(
        x=r1.x.index_copy(0, idx, r2.x),
        residual=r1.residual.index_copy(0, idx, r2.residual),
        converged=r1.converged.index_copy(0, idx, r2.converged),
        matvecs=r1.matvecs.index_add(0, idx, r2.matvecs),
        iterations=r1.iterations.index_add(0, idx, r2.iterations),
        solve_time=r1.solve_time,
        trace=trace,
    )


def host_compact_finish(run2, A, b, r1, proj, eligible=None):
    """Gather the lanes of ``r1`` selected by ``eligible`` (default: the
    unconverged ones), re-solve them warm-started via
    ``run2(A2, b2, x02, proj) -> SolveResult`` and scatter the results
    back."""
    mask = ~r1.converged if eligible is None else eligible
    idx = torch.nonzero(mask).squeeze(1)
    if idx.numel() == 0:
        return r1
    return _scatter(r1, idx, run2(_gather_A(A, idx), b[idx], r1.x[idx], proj))


def solve_batched_fused_compact(solver, A, b, phase1_matvecs, x0=None,
                                proj=None, config=None, bucket=256,
                                host_fallback=True, keys=None):
    """Two-phase straggler compaction.

    Phase 1 solves every lane on a budget of ``phase1_matvecs``.  Phase 2
    gathers the first ``bucket`` unconverged lanes (in lane order), warm-
    starts them from their phase-1 iterates on the remaining budget, and
    scatters the results back.  If more than ``bucket`` lanes miss phase 1,
    the overflow lanes keep their honest phase-1 state (converged=False);
    with ``host_fallback=True`` a further compacted pass finishes them.
    A: (B, n, n) tensor or operator; the projection is shared by all lanes.
    """
    if not isinstance(solver, str):
        raise TypeError("solve_batched_fused_compact takes a solver NAME")
    _no_keys(keys)
    remaining = int(config.max_matvecs) - int(phase1_matvecs)
    if remaining < 4:
        raise ValueError(
            f"phase1_matvecs={phase1_matvecs} leaves {remaining} < 4 matvecs "
            f"for phase 2 of a max_matvecs={config.max_matvecs} budget")
    cfg1 = dataclasses.replace(config, max_matvecs=int(phase1_matvecs))
    cfg2 = dataclasses.replace(config, max_matvecs=remaining)
    fn = _get_solver(solver)

    def run2(A2, b2, x02, proj2):
        return fn(A2, b2, x0=x02, proj=proj2, config=cfg2)

    r = fn(A, b, x0=x0, proj=proj, config=cfg1)
    idx = torch.nonzero(~r.converged).squeeze(1)[:int(bucket)]
    if idx.numel() > 0:
        r = _scatter(r, idx, run2(_gather_A(A, idx), b[idx], r.x[idx], proj))
    if not host_fallback:
        return r
    # Overflow lanes spent only the phase-1 budget; lanes that exhausted the
    # full budget keep their honest converged=False.
    eligible = ~r.converged & (r.matvecs < int(config.max_matvecs))
    return host_compact_finish(run2, A, b, r, proj, eligible=eligible)
