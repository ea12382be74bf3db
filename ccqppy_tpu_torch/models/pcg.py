"""PCG -- projected conjugate gradients with active-set restarts, batched.

Port of the plain verified path of ``ccqppy_tpu/models/pcg.py`` (``_solve``;
see that module for the algorithm and the measurements behind it).  On a
set that is not polyhedral it delegates to fused MPRGP-BB
(``models/mprgp.py``), as the JAX package does.  Per iteration, for state
``x`` feasible and ``g = A x + b``:

1. ``Ap = A p``                                   (the only matvec)
2. ``alpha = min(alpha_cg, alpha_feasible)``
3. ``x += alpha p``; ``g += alpha Ap``
4. refresh the binding mask ``m``; ``r = -m g``, ``z = m M^-1 r``
5. restart CG (``beta = 0``) when the mask changed or the step hit a bound.

Each inner segment runs on the carried gradient until it claims
convergence (or stalls, or meets the budget); one fresh sweep
``g = A x + b`` then verifies the claim, and the segment resumes from the
exact gradient until the true residual passes.

Batching: the JAX package ``vmap``s nested ``lax.while_loop``s, which gives
exact per-lane results.  Here the lanes are an explicit leading axis:

* every scalar of the JAX state (``alpha``, ``rr``, ``res``, ``mv``,
  ``it``, ``done``) is a ``(B,)`` tensor, and every reduction runs over the
  last dimension only;
* an outer Python loop runs while any lane is not done; inside it an inner
  loop runs while any outer-active lane is not inner-done, and one
  verification sweep serves every outer-active lane;
* each sweep is one batched matvec over all B lanes, as under ``vmap``;
  lanes that are not active keep their state through ``torch.where``, and
  their counters do not advance.

The host reads one "any lane left?" flag per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models import mprgp
from ccqppy_tpu_torch.models.base import (SolverConfig, default_x0, eps_of,
                                          init_trace, make_result,
                                          pg_residual, record_trace,
                                          select_lanes)
from ccqppy_tpu_torch.ops.linop import as_operator
from ccqppy_tpu_torch.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class PCGConfig(SolverConfig):
    """precond: "none" or "jacobi" (M = diag(A) on the free set).

    refresh_every > 0 selects the JAX package's mixed-precision residual
    replacement, which is not ported yet; ``inner_margin``,
    ``refresh_restart`` and ``segment_drop`` belong to it and are kept so
    that configurations carry over field for field."""

    precond: str = "none"
    refresh_every: int = 0
    inner_margin: float = 0.3
    refresh_restart: bool = True
    segment_drop: float = 0.0


class _State(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor     # binding mask (1 = coordinate free to move)
    r: torch.Tensor     # face-restricted steepest descent -m*g
    p: torch.Tensor     # conjugate direction (supported on the free set)
    rr: torch.Tensor    # r.z (== r.r unpreconditioned)
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: torch.Tensor


def solve(A, b, x0=None, proj=None, config: PCGConfig = PCGConfig()):
    """Projected CG with active-set restarts on a batch of QPs; on a set
    that is not polyhedral, fused MPRGP-BB with the same tolerance, budget,
    gd and trace length.

    A: (B, n, n) tensor or operator; b: (B, n); x0: (B, n) or None.
    Returns a ``SolveResult`` whose ``residual`` and ``converged`` come from
    a freshly recomputed gradient on every lane.
    """
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if not proj.polyhedral:
        # Curved sets break PCG's exact feasible steps and per-coordinate
        # binding mask; as the JAX package does, delegate to fused MPRGP-BB.
        cfg = mprgp.MPRGPBBConfig(tol=config.tol, max_matvecs=config.max_matvecs,
                                  gd=config.gd, trace_len=config.trace_len)
        return mprgp.solve_bb(op, b, x0, proj, cfg)
    if config.refresh_every > 0:
        raise NotImplementedError(
            "pcg residual replacement (refresh_every > 0) is not ported yet "
            "(ROADMAP queue 1 item 12)")
    if config.precond not in ("none", "jacobi"):
        raise ValueError(f"precond must be 'none' or 'jacobi', not {config.precond!r}")
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    x0 = default_x0(b, x0, proj)
    tiny = eps_of(b)
    tol, budget = config.tol, config.max_matvecs

    if config.precond == "jacobi":
        dinv = 1.0 / torch.clamp(op.diagonal(), min=tiny)
        prec = lambda r: dinv * r  # noqa: E731
    else:
        prec = lambda r: r  # noqa: E731

    def lanes(v):
        return v[:, None]

    def body(s):
        Ap = op.matvec(s.p)
        mv = s.mv + 1
        mAp = s.m * Ap
        pAp = op.dot(s.p, mAp)
        alpha_cg = s.rr / (pAp + tiny)
        # max_feasible_step is defined for steps x - a*q; we move along +p.
        alpha_f = op.reduce_min(proj.max_feasible_step(s.x, -s.p))
        alpha = torch.minimum(alpha_cg, torch.clamp(alpha_f, min=0.0))
        # project() only clears fp dust: the step is feasible by construction.
        x = proj.project(s.x + lanes(alpha) * s.p)
        g = s.g + lanes(alpha) * Ap
        # Snap newly-binding coordinates exactly onto their bound (see
        # Projection.snap_binding).
        x = proj.snap_binding(x, g)
        m = proj.binding_mask(x, g)
        changed = (m != s.m).any(dim=-1)
        r = -m * g
        z = m * prec(r)
        rr = op.dot(r, z)
        restart = changed | (alpha_f < alpha_cg)
        beta = torch.where(restart, 0.0, rr / (s.rr + tiny))
        p = z + lanes(beta) * s.p
        res = pg_residual(proj, x, g, config.gd, op)
        # rr == 0 exactly: a fully frozen mask, no direction left to move in.
        # ``mv + 1``: one matvec of budget is reserved for the verification.
        done = (res < tol) | (mv + 1 >= budget) | (rr == 0)
        return _State(x, g, m, r, p, rr, res, mv, s.it + 1, done,
                      record_trace(s.trace, s.it, res))

    def inner_init(o):
        x = proj.snap_binding(o.x, o.g)
        m = proj.binding_mask(x, o.g)
        r = -m * o.g
        z = m * prec(r)
        rr = op.dot(r, z)
        return _State(x=x, g=o.g, m=m, r=r, p=z, rr=rr, res=o.res, mv=o.mv,
                      it=o.it, done=(o.res < tol) | (o.mv + 1 >= budget)
                      | (rr == 0), trace=o.trace)

    g0 = op.matvec(x0) + b
    x0 = proj.snap_binding(x0, g0)
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    B = b.shape[0]
    zeros = torch.zeros_like(b)
    o = _State(x=x0, g=g0, m=zeros, r=zeros, p=zeros,
               rr=torch.zeros(B, dtype=b.dtype, device=b.device), res=res0,
               mv=torch.ones(B, dtype=torch.int32, device=b.device),
               it=torch.zeros(B, dtype=torch.int32, device=b.device),
               done=(res0 < tol) | (1 >= budget),
               trace=init_trace(config, B, b.dtype, b.device))

    while True:
        outer = ~o.done
        if not bool(outer.any()):
            break
        s = inner_init(o)
        while True:
            active = outer & ~s.done
            if not bool(active.any()):
                break
            s = select_lanes(active, body(s), s)
        # Verification sweep for every outer-active lane.
        g_t = op.matvec_exact(s.x) + b
        mv = s.mv + 1
        res_t = pg_residual(proj, s.x, g_t, config.gd, op)
        # it == o.it: the segment had no room to move (frozen mask or
        # budget); a further segment would spin.
        done = (res_t < tol) | (mv >= budget) | (s.it == o.it)
        o = select_lanes(outer, _State(s.x, g_t, s.m, s.r, s.p, s.rr, res_t, mv,
                                  s.it, done, s.trace), o)

    result = make_result(o.x, o.res, o.mv, o.it, budget, o.trace)
    # The stagnation exit would read as converged under the budget
    # semantics; report the honest criterion (o.res is a fresh residual).
    return dataclasses.replace(result, converged=o.res < tol)
