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

On the card, for a box (bounds ``(n,)`` or ``(B, n)``, n <= 2048) and no
residual trace, an inner iteration is the GEMV and one launch of the fused
step kernel (``ops/pcg_step.py``, ``csrc/pcg_step.cu``), in place on the
state; every other set, the CPU, a trace, rr-PCG and the sharded operators
run the eager body ``_body`` with its select (``_step_args`` says which).
``PCG_STEPS_FUSED`` and ``PCG_STEPS_EAGER`` count the iterations on each.
The verification sweep and a segment's start stay eager.

With ``refresh_every > 0`` the solve is the JAX package's residual
replacement (``_solve_rr``): inner segments of CG on ``op.matvec`` (for
``MixedPrecDense`` the bf16 sweep), each closed by one ``op.matvec_exact``
refresh that recomputes the gradient and decides convergence.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models import mprgp
from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          eps_of, init_trace, lanes,
                                          make_result, pg_residual,
                                          record_trace, select_lanes)
from ccqppy_tpu_torch.ops import pcg_step
from ccqppy_tpu_torch.ops.linop import LinearOperator, as_operator
from ccqppy_tpu_torch.ops.projections import identity
from ccqppy_tpu_torch.ops.step_common import fused_set_args

#: Iterations of PCG's inner loops (plain and rr-PCG) on the fused step
#: kernel and on the eager body, in this process.
PCG_STEPS_FUSED = 0
PCG_STEPS_EAGER = 0


@dataclasses.dataclass(frozen=True)
class PCGConfig(SolverConfig):
    """precond: "none" or "jacobi" (M = diag(A) on the free set).

    refresh_every: 0 is plain PCG.  > 0 is mixed-precision residual
    replacement: CG segments of at most ``refresh_every`` iterations on
    ``op.matvec``, each ended by an exact gradient ``op.matvec_exact(x) + b``
    whose true Eq. 25 residual alone decides convergence.

    inner_margin: a segment also ends when its own residual estimate falls
    below ``tol * inner_margin``.

    segment_drop: with c > 0, a segment also ends once its estimate falls
    below ``c`` times the residual at the segment's start (a low-precision
    cycle cannot cash more; ~3e-2 suits bf16).

    refresh_restart: True restarts CG (beta = 0) at every refresh; False
    keeps the conjugate direction across it (beta from the exact r.z over
    the last inner r.z, unless the refresh changed the mask)."""

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
    if config.precond not in ("none", "jacobi"):
        raise ValueError(f"precond must be 'none' or 'jacobi', not {config.precond!r}")
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    x0 = default_x0(b, x0, proj)
    tiny = eps_of(b)
    tol, budget = config.tol, config.max_matvecs

    dinv = None
    if config.precond == "jacobi":
        dinv = 1.0 / torch.clamp(op.diagonal(), min=tiny)
        prec = lambda r: dinv * r  # noqa: E731
    else:
        prec = lambda r: r  # noqa: E731

    if config.refresh_every > 0:
        return _solve_rr(op, b, x0, proj, config, prec, tiny)
    sargs = _step_args(op, b, proj, config, dinv)
    body = lambda s, Ap: _body(s, op, proj, prec, tiny, config, Ap)  # noqa: E731

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
        if not any_lane(outer):
            break
        s = inner_init(o)
        if sargs is None:
            s = _inner_eager(s, outer, body)
        else:
            s = _inner_fused(s, outer, op, b, sargs, dinv, config, tiny, body)
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


class _RRInner(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor     # carried (cheap-operator) gradient
    m: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rr: torch.Tensor
    thr: torch.Tensor   # segment stop threshold on the residual estimate
    mv: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor


class _RROuter(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor     # exact gradient (op.matvec_exact)
    m: torch.Tensor
    p: torch.Tensor     # carried conjugate direction (keep-p mode)
    rr: torch.Tensor    # last inner r.z (the cross-segment beta)
    fresh: torch.Tensor  # True: the next segment starts steepest-descent
    res: torch.Tensor   # true Eq. 25 residual at the last refresh
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: torch.Tensor


def _body(s, op, proj, prec, tiny, config, Ap=None):
    """One eager iteration of plain PCG's inner loop on every lane (the
    caller keeps the lanes that do not run): the plain version of
    ``ops.pcg_step``.  ``Ap`` is the sweep ``A p`` when the caller has
    taken it."""
    x, g, m, r, p, rr = pcg_step.cg_step(op, proj, prec, tiny, s, Ap)
    mv = s.mv + 1
    res = pg_residual(proj, x, g, config.gd, op)
    # rr == 0 exactly: a fully frozen mask, no direction left to move in.
    # ``mv + 1``: one matvec of budget is reserved for the verification.
    done = (res < config.tol) | (mv + 1 >= config.max_matvecs) | (rr == 0)
    return _State(x, g, m, r, p, rr, res, mv, s.it + 1, done,
                  record_trace(s.trace, s.it, res))


def _step_args(op, b, proj, config, dinv):
    """The box's ``SetArgs`` when plain PCG's inner loop may run the fused
    step, else None: ``step_common.fused_set_args`` gives a box; plain PCG
    (``refresh_every == 0``); the operator's ``reduce_min`` is
    ``LinearOperator``'s (a sharded operator's all-reduce keeps the eager
    body); a lane of at most ``pcg_step.MAX_N`` coordinates; and Jacobi's
    ``dinv``, if any, contiguous in b's dtype on b's device, ``(n,)`` or
    ``(B, n)``."""
    sargs = fused_set_args(op, b, proj, config.trace_len)
    if sargs is None or sargs.kind != "box" or config.refresh_every > 0:
        return None
    if type(op).reduce_min is not LinearOperator.reduce_min or b.shape[-1] > pcg_step.MAX_N:
        return None
    if dinv is not None and not (dinv.dtype == b.dtype and dinv.device == b.device
                                 and dinv.is_contiguous()
                                 and dinv.shape in (b.shape[-1:], b.shape)):
        return None
    return sargs


def _inner_eager(s, outer, body, Ap=None):
    """Plain PCG's inner loop on the eager ``body(s, Ap)`` with the select of
    the running lanes; ``Ap``, when given, is the first iteration's sweep."""
    global PCG_STEPS_EAGER
    while True:
        active = outer & ~s.done
        if not any_lane(active):
            return s
        s = select_lanes(active, body(s, Ap), s)
        Ap = None
        PCG_STEPS_EAGER += 1


def _inner_fused(s, outer, op, b, sargs, dinv, config, tiny, body):
    """Plain PCG's inner loop with the fused step: the GEMV on p, the step
    kernel and the "any lane running?" test of the ``active`` flags it
    keeps, three kernels an iteration, in place on the state.
    ``inner_init`` shares g, res, mv and it with the outer state, which
    reads them after the loop: they are copied first.  An ``A p`` in another
    dtype than b goes to the eager loop, with the state as it stands."""
    global PCG_STEPS_FUSED
    s = s._replace(**{f: getattr(s, f).clone(memory_format=torch.contiguous_format)
                      for f in ("g", "res", "mv", "it")},
                   **{f: getattr(s, f).contiguous() for f in ("x", "m", "p", "rr", "done")})
    active = outer & ~s.done          # the step clears a lane it finishes
    while any_lane(active):
        Ap = op.matvec(s.p)
        if Ap.dtype != b.dtype:
            return _inner_eager(s, outer, body, Ap)
        pcg_step.step(sargs, Ap.contiguous(), b, s, active, dinv, tol=config.tol, gd=config.gd,
                      budget=config.max_matvecs, tiny=tiny)
        PCG_STEPS_FUSED += 1
    return s


def _solve_rr(op, b, x0, proj, config, prec, tiny):
    """Residual-replacement PCG (``PCGConfig.refresh_every``): an outer loop
    of exact refreshes around inner segments of cheap CG iterations.  Every
    inner step is one cheap sweep over all lanes, every refresh one exact
    sweep; both count as matvecs, and a lane's counters move only while it
    is active.  The trace records the true residual of each refresh."""
    global PCG_STEPS_EAGER
    K = int(config.refresh_every)
    tol, budget = config.tol, config.max_matvecs
    inner_tol = tol * config.inner_margin

    def inner_body(t):
        x, g, m, r, p, rr = pcg_step.cg_step(op, proj, prec, tiny, t)  # the cheap sweep
        # The estimate on the carried gradient only ends the segment.  The
        # ``+ 2`` keeps room for the segment's exact refresh in the budget.
        res_est = pg_residual(proj, x, g, config.gd, op)
        done = (res_est < t.thr) | (rr == 0) | (t.k + 1 >= K) | (t.mv + 2 >= budget)
        return _RRInner(x, g, m, r, p, rr, t.thr, t.mv + 1, t.k + 1, done)

    g0 = op.matvec_exact(x0) + b
    x0 = proj.snap_binding(x0, g0)
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    B = b.shape[0]
    s = _RROuter(x=x0, g=g0, m=proj.binding_mask(x0, g0), p=torch.zeros_like(b),
                 rr=torch.ones(B, dtype=b.dtype, device=b.device),
                 fresh=torch.ones(B, dtype=torch.bool, device=b.device), res=res0,
                 mv=torch.ones(B, dtype=torch.int32, device=b.device),
                 it=torch.zeros(B, dtype=torch.int32, device=b.device),
                 done=(res0 < tol) | (1 >= budget),
                 trace=init_trace(config, B, b.dtype, b.device))

    while True:
        outer = ~s.done
        if not any_lane(outer):
            break
        # Segment start: exact steepest descent on the free set, conjugated
        # against the carried direction in keep-p mode.
        r0 = -s.m * s.g
        z0 = s.m * prec(r0)
        rr0 = op.dot(r0, z0)
        if config.refresh_restart:
            p0 = z0
        else:
            p0 = z0 + lanes(torch.where(s.fresh, 0.0, rr0 / (s.rr + tiny))) * s.p
        thr = torch.full_like(s.res, inner_tol)
        if config.segment_drop > 0:
            thr = torch.maximum(thr, config.segment_drop * s.res)
        t = _RRInner(s.x, s.g, s.m, r0, p0, rr0, thr, s.mv, torch.zeros_like(s.it),
                     (rr0 == 0) | (s.mv >= budget))
        while True:
            active = outer & ~t.done
            if not any_lane(active):
                break
            t = select_lanes(active, inner_body(t), t)
            PCG_STEPS_EAGER += 1
        # Exact refresh: gradient, mask, true residual.
        g = op.matvec_exact(t.x) + b
        mv = t.mv + 1
        m = proj.binding_mask(t.x, g)
        res = pg_residual(proj, t.x, g, config.gd, op)
        # k == 0: the segment had no free direction; a further one would spin.
        done = (res < tol) | (mv >= budget) | (t.k == 0)
        fresh = (m != t.m).any(dim=-1)
        s = select_lanes(outer, _RROuter(t.x, g, m, t.p, t.rr, fresh, res, mv,
                                         s.it + t.k, done,
                                         record_trace(s.trace, s.it, res)), s)

    result = make_result(s.x, s.res, s.mv, s.it, budget, s.trace)
    return dataclasses.replace(result, converged=s.res < tol)
