"""Scenario batching with straggler compaction.

Port of ``solve_batched``, ``solve_batched_sharded``, ``make_batch_mesh``,
``solve_batched_compact``, ``host_compact_finish`` and
``solve_batched_fused_compact`` from ``ccqppy_tpu/parallel/batch.py``.
The port's solvers are batched already, so ``solve_batched`` is a direct
call.  Compaction gathers the unconverged lanes (plain indexing of a raw
stack, ``take`` of an operator) and re-solves exactly those lanes: per-lane
results do not depend on the other lanes of a batch, so the JAX package's
power-of-two padding, which only bounded recompilation, is not needed.

Projection parameters are shared by all lanes, or, with
``proj_batched=True``, carry a leading lane axis on every buffer; they then
broadcast against the ``(B, n)`` points as they are, and compaction gathers
them with the lanes (``Projection.take``).

RNG keys (the SPG solver's) are a ``(B,)`` int64 tensor of per-lane seeds
(``utils.rng``), passed as ``keys=`` to the solver (one that takes none
raises ``TypeError``, as in the JAX package) and gathered with the lanes.
A lane's draws depend only on its key and its own iteration count, so a
gathered straggler keeps its stream.  ``solve_batched_compact`` restarts
phase 2 on the same keys, as the JAX package does; the fused path gives
phase 2, in the bucket and in the host fallback, ``fold_in(keys, 1)``.
With no keys, SPG seeds its batch with ``split_keys(0, B)``, which in a
compacted batch depends on the lane's place in it: pass keys for streams
that follow the lanes.

Spans (``models.base.span``; recorded only while ``torch.profiler``
records, else never entered): ``ccqppy.solve`` around each public batch
entry (``solve_batched``, ``solve_batched_compact``,
``solve_batched_fused_compact``; one per call, not one per nested entry),
``ccqppy.phase1`` around the phase-1 solve, ``ccqppy.gather`` around the
selection of the lanes to re-solve and the gather of their inputs,
``ccqppy.phase2`` around their re-solve and scatter, and
``ccqppy.fallback`` around the fused path's host fallback.
"""
from __future__ import annotations

import dataclasses

import torch

from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.models.base import SolveResult, lane_indices, span
from ccqppy_tpu_torch.ops.linop import LinearOperator
from ccqppy_tpu_torch.parallel.distributed import mesh_1d, mesh_axis
from ccqppy_tpu_torch.utils import rng


def _get_solver(solver):
    if isinstance(solver, str):
        return SOLVERS[solver][0]
    return solver


def _solver_kwargs(config, keys):
    """The keyword arguments of a solver call: the config, if any, and the
    keys, if any."""
    kwargs = {} if config is None else {"config": config}
    if keys is not None:
        kwargs["keys"] = keys
    return kwargs


def _check_lane_proj(proj, B, proj_batched):
    """With ``proj_batched``, every projection buffer leads with the lane
    axis."""
    if not proj_batched:
        return
    bad = {k: tuple(v.shape) for k, v in proj.parameter_buffers()
           if v.dim() == 0 or v.shape[0] != B}
    if bad:
        raise ValueError(f"proj_batched=True needs a leading lane axis of {B} on "
                         f"every projection parameter: {bad}")


def _lane_proj(proj, idx, proj_batched):
    """The projection for lanes ``idx``."""
    return proj.take(idx) if proj_batched else proj


def solve_batched(solver, A, b, x0=None, proj=None, config=None, keys=None,
                  proj_batched=False):
    """Solve a batch of QPs: A (B, n, n), b (B, n), x0 (B, n) or None.
    ``keys``: (B,) int64 per-lane seeds for a solver that takes them (SPG).
    Returns a ``SolveResult`` with a leading lane axis on every field."""
    with span("ccqppy.solve"):
        return _solve_batched(solver, A, b, x0, proj, config, keys, proj_batched)


def _solve_batched(solver, A, b, x0, proj, config, keys, proj_batched):
    if keys is not None:
        rng.check_keys(keys, b.shape[0], b.device)
    _check_lane_proj(proj, b.shape[0], proj_batched)
    return _get_solver(solver)(A, b, x0=x0, proj=proj, **_solver_kwargs(config, keys))


def solve_batched_sharded(solver, A, b, mesh, axis="batch", x0=None,
                          proj=None, config=None, keys=None,
                          proj_batched=False):
    """Scenario parallelism: the batch split over the ranks of
    ``mesh[axis]``, each rank solving its contiguous ``B / size`` lanes
    with ``solve_batched``.

    Every rank passes the whole batch: A (B, n, n) tensor or operator, b,
    x0 and keys with a leading lane axis, the projection shared or, with
    ``proj_batched``, per lane.  A rank takes its lanes (views of a tensor,
    ``take`` of an operator or a per-lane projection) and returns their
    ``SolveResult``.  No collective runs: the ranks never wait on each
    other, and each lane's result is the one ``solve_batched`` gives it.
    The batch size must divide the axis size.
    """
    _, size, rank = mesh_axis(mesh, axis)
    B = b.shape[0]
    if B % size:
        raise ValueError(f"batch {B} must divide the mesh axis size {size}")
    lo, hi = rank * (B // size), (rank + 1) * (B // size)
    idx = torch.arange(lo, hi, device=b.device)
    # Every axis size slices the same way, one rank included; only an
    # operator the rank holds whole is kept as it is (``take`` copies).
    if not isinstance(A, LinearOperator):
        A = A[lo:hi]
    elif (lo, hi) != (0, B):
        A = A.take(idx)
    proj = _lane_proj(proj, idx, proj_batched)
    b, x0, keys = (None if t is None else t[lo:hi] for t in (b, x0, keys))
    return solve_batched(solver, A, b, x0=x0, proj=proj, config=config, keys=keys,
                         proj_batched=proj_batched)


def make_batch_mesh(n_devices=None, axis="batch"):
    """1-D mesh named ``axis`` over ranks 0 .. ``n_devices`` - 1 (default:
    every rank)."""
    return mesh_1d(n_devices, axis)


def _phases(solver, config, phase1_matvecs):
    """(solver function, phase 1's config, phase 2's ``run2(A2, b2, x02,
    proj2, keys2)``): phase 1 on ``phase1_matvecs``, phase 2 on what phase 1
    left of ``config.max_matvecs`` (at least 4)."""
    remaining = int(config.max_matvecs) - int(phase1_matvecs)
    if remaining < 4:
        raise ValueError(
            f"phase1_matvecs={phase1_matvecs} leaves {remaining} < 4 matvecs "
            f"for phase 2 of a max_matvecs={config.max_matvecs} budget; pick "
            "a smaller phase-1 budget (~2x the median solve cost)")
    fn = _get_solver(solver)
    cfg2 = dataclasses.replace(config, max_matvecs=remaining)

    def run2(A2, b2, x02, proj2, keys2):
        return fn(A2, b2, x0=x02, proj=proj2, **_solver_kwargs(cfg2, keys2))

    return fn, dataclasses.replace(config, max_matvecs=int(phase1_matvecs)), run2


def solve_batched_compact(solver, A, b, phase1_matvecs, x0=None, proj=None,
                          config=None, keys=None, proj_batched=False):
    """Two-phase batched solve with straggler compaction on the host.

    Phase 1 solves every lane on a budget of ``phase1_matvecs`` (pick ~2x
    the median cost); phase 2 gathers the unconverged lanes, warm-starts
    them from their phase-1 iterates and runs them on the budget phase 1
    left.  Matvec and iteration counts accumulate per lane.  Phase 2 runs
    on the same ``keys`` as phase 1, as the JAX package's does.  The
    continuation is not trajectory-identical to an uninterrupted solve
    (step sizes re-seed at the restart): convergence semantics, not
    trajectories, are preserved."""
    fn, cfg1, run2 = _phases(solver, config, phase1_matvecs)
    with span("ccqppy.solve"):
        with span("ccqppy.phase1"):
            r1 = _solve_batched(fn, A, b, x0, proj, cfg1, keys, proj_batched)
        return host_compact_finish(run2, A, b, r1, proj, keys=keys,
                                   proj_batched=proj_batched)


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


def _gather_lanes(A, b, x, proj, keys, idx, proj_batched):
    """The arguments of ``run2`` for lanes ``idx``: their Hessians,
    right-hand sides, start points, projection (with ``proj_batched``) and
    keys (if any)."""
    return (_gather_A(A, idx), b[idx], x[idx], _lane_proj(proj, idx, proj_batched),
            None if keys is None else keys[idx])


def host_compact_finish(run2, A, b, r1, proj, keys=None, eligible=None,
                        proj_batched=False):
    """Gather the lanes of ``r1`` selected by ``eligible`` (default: the
    unconverged ones), re-solve them warm-started via
    ``run2(A2, b2, x02, proj2, keys2) -> SolveResult`` and scatter the
    results back.  With ``proj_batched`` the projection's lanes are
    gathered too, and with ``keys`` the keys (``keys2`` is None without)."""
    mask = ~r1.converged if eligible is None else eligible
    with span("ccqppy.gather"):
        idx = lane_indices(mask)
        if idx.numel() == 0:
            return r1
        inputs = _gather_lanes(A, b, r1.x, proj, keys, idx, proj_batched)
    with span("ccqppy.phase2"):
        return _scatter(r1, idx, run2(*inputs))


def solve_batched_fused_compact(solver, A, b, phase1_matvecs, x0=None,
                                proj=None, config=None, bucket=256,
                                host_fallback=True, keys=None, proj_batched=False):
    """Two-phase straggler compaction.

    Phase 1 solves every lane on a budget of ``phase1_matvecs``.  Phase 2
    gathers the first ``bucket`` unconverged lanes (in lane order), warm-
    starts them from their phase-1 iterates on the remaining budget, and
    scatters the results back.  If more than ``bucket`` lanes miss phase 1,
    the overflow lanes keep their honest phase-1 state (converged=False);
    with ``host_fallback=True`` a further compacted pass finishes them.
    A: (B, n, n) tensor or operator; the projection is shared by all lanes,
    or per lane with ``proj_batched``.  Phase 2 runs on
    ``fold_in(keys, 1)``, in the bucket and in the fallback alike.
    """
    if not isinstance(solver, str):
        raise TypeError("solve_batched_fused_compact takes a solver NAME")
    with span("ccqppy.solve"):
        if keys is not None:
            rng.check_keys(keys, b.shape[0], b.device)
        _check_lane_proj(proj, b.shape[0], proj_batched)
        fn, cfg1, run2 = _phases(solver, config, phase1_matvecs)
        with span("ccqppy.phase1"):
            r = fn(A, b, x0=x0, proj=proj, **_solver_kwargs(cfg1, keys))
        # Phase 2 draws from a stream of its own: each lane's key with 1 folded in.
        keys2 = None if keys is None else rng.fold_in(keys, 1)
        with span("ccqppy.gather"):
            idx = lane_indices(~r.converged)[:int(bucket)]
            inputs = (_gather_lanes(A, b, r.x, proj, keys2, idx, proj_batched)
                      if idx.numel() > 0 else None)
        if inputs is not None:
            with span("ccqppy.phase2"):
                r = _scatter(r, idx, run2(*inputs))
        if not host_fallback:
            return r
        # Overflow lanes spent only the phase-1 budget; lanes that exhausted the
        # full budget keep their honest converged=False.
        eligible = ~r.converged & (r.matvecs < int(config.max_matvecs))
        with span("ccqppy.fallback"):
            return host_compact_finish(run2, A, b, r, proj, keys=keys2, eligible=eligible,
                                       proj_batched=proj_batched)
