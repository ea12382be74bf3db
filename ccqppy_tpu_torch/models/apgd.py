"""Accelerated projected gradient, batched: classic APGD with backtracking
(``solve``), its anti-relaxation variant APGD-AR
(``solve_anti_relaxation``), and the strong-convexity variant
(``solve_sc``).

Port of ``APGDConfig``, ``solve``, ``solve_anti_relaxation``,
``APGDSCConfig`` and ``solve_sc`` from ``ccqppy_tpu/models/apgd.py`` (see
that module for the algorithms and their measurements).

Classic APGD (Pospisil 2015 Alg. 6 with Mazhar-2015 backtracking) starts
from ``L0 = ||A (x0 - 1)|| / ||x0 - 1||`` (one matvec) and per iteration
does ``A y`` and ``A x1`` for the trial point at step 1/L.  The JAX
package's backtracking ``lax.while_loop`` becomes an inner host loop: while
an active lane fails the quadratic bound (with the ``backtrack_slack``
rounding slack), has budget left and has not reached ``max_backtracks``,
every lane gets one batched trial matvec, and only the lanes still
backtracking take it and count it, as under ``vmap``.  An iteration can
therefore end one matvec over the budget.  APGD-AR restarts momentum when
``g.(x1 - x) > 0`` and returns the best-residual iterate ``xhat`` with the
LAST iterate's residual, as the JAX package does.

``solve_sc``: with spectral bounds L >= lambda_max and mu <= lambda_min
per lane, the schedule is a fixed step 1/L with constant momentum
beta = (1 - sqrt(q)) / (1 + sqrt(q)), q = clip(mu / L): one matvec per
iteration, no backtracking.  Verified convergence: the gradient of an
iteration is fresh at the extrapolated point y, so the residual at the new
iterate is a claim; a ``verifying`` iteration spends its matvec on ``A x``
and only a fresh residual below tol may exit.  A failed claim resumes with
a plain prox step from x.  Momentum restarts (O'Donoghue-Candes) when the
prox-gradient direction opposes the momentum.

Batching as in ``models/pcg.py``: lanes are the leading axis, every scalar
of the JAX state is a ``(B,)`` tensor, lanes that are done keep their state
through ``torch.where``, and the host reads one "any lane left?" flag per
iteration (and classic APGD one more per backtracking trial).

``solve_sc`` on the card runs each iteration as the GEMV and one fused
kernel (``ops.sc_step``, ``csrc/apgd_sc_step.cu``), which computes the
eager body ``_sc_body`` and the select of the running lanes in place, branch
for branch, and writes the next GEMV's input: with the flag's two kernels,
four launches an iteration where the eager body takes ~220.  It does so
when what it can observe allows (``ops.step_common.fused_set_args``, the
rule MPRGP's step kernel shares): ``b`` a contiguous f32 or f64 CUDA tensor,
the operator's ``dot`` and ``global_size`` those of ``LinearOperator`` (a
sharded operator's all-reduce ``dot`` keeps the eager body), no trace
(``trace_len == 0``), and a set that ``ops.step_common.set_args`` takes (a
blockwise Lorentz cone with one mu or one a block, a box with ``(n,)`` or
``(B, n)`` bounds).  The operator's output decides last: an ``A v`` in
another dtype than b (f64 blocks under an f32 b) hands that iteration and
the rest to the eager body, which promotes the state with it.  Everything
else, the CPU included, runs the eager body.  ``SC_STEPS_FUSED`` and
``SC_STEPS_EAGER`` count the iterations of each path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          init_trace, lanes, make_result,
                                          pg_residual, record_trace,
                                          select_lanes, where_lanes)
from ccqppy_tpu_torch.ops import sc_step
from ccqppy_tpu_torch.ops.linop import as_operator, power_spectral_bounds
from ccqppy_tpu_torch.ops.projections import identity
from ccqppy_tpu_torch.ops.step_common import fused_set_args

#: Iterations of ``solve_sc`` in this process, by path: the fused kernel on
#: the card, or the eager body.
SC_STEPS_FUSED = 0
SC_STEPS_EAGER = 0


@dataclasses.dataclass(frozen=True)
class APGDConfig(SolverConfig):
    """backtrack_grow:  L multiplier on a failed Lipschitz trial.
    relax:            L multiplier after each outer iteration.
    max_backtracks:   bound on the trials of one iteration (a guard).
    anti_relaxation:  the Mazhar best-iterate + restart variant.
    backtrack_slack:  rounding slack of the Lipschitz test in units of
                      machine eps (0 is the reference's strict test)."""

    backtrack_grow: float = 2.0
    relax: float = 0.9
    max_backtracks: int = 64
    anti_relaxation: bool = False
    backtrack_slack: float = 16.0


class _APGDState(NamedTuple):
    x: torch.Tensor       # x_k
    y: torch.Tensor       # extrapolated point y_k
    theta: torch.Tensor
    L: torch.Tensor
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    # anti-relaxation tracking
    resmin: torch.Tensor
    xhat: torch.Tensor
    trace: torch.Tensor


class _Trial(NamedTuple):
    x1: torch.Tensor
    Ax1: torch.Tensor
    ok: torch.Tensor


def solve(A, b, x0=None, proj=None, config: APGDConfig = APGDConfig()):
    """Classic APGD (or APGD-AR with ``config.anti_relaxation``) on a batch
    of QPs: A (B, n, n) tensor or operator, b (B, n), x0 (B, n) or None."""
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    x0 = default_x0(b, x0, proj)
    B = b.shape[0]
    budget = config.max_matvecs
    slack = config.backtrack_slack * torch.finfo(b.dtype).eps

    # L0 = ||A (x0 - 1)|| / ||x0 - 1||, guarded against x0 == 1.
    xdiff = x0 - 1
    num = op.norm(op.matvec(xdiff))
    den = op.norm(xdiff)
    L0 = torch.where(den > 0, num / torch.where(den > 0, den, 1), 1.0)
    inf = torch.full((B,), torch.inf, dtype=b.dtype, device=b.device)
    s = _APGDState(x=x0, y=x0, theta=torch.ones_like(inf), L=L0, res=inf,
                   mv=torch.ones(B, dtype=torch.int32, device=b.device),
                   it=torch.zeros(B, dtype=torch.int32, device=b.device),
                   done=torch.zeros(B, dtype=torch.bool, device=b.device),
                   resmin=inf, xhat=x0, trace=init_trace(config, B, b.dtype, b.device))

    def body(s, active):
        Ay = op.matvec(s.y)
        g = Ay + b
        rhs_const = 0.5 * op.dot(s.y, Ay) + op.dot(s.y, b)

        def trial(L):
            """The point at step 1/L, its matvec, and whether the quadratic
            bound f(x1) <= f(y) + g.(x1 - y) + L/2 ||x1 - y||^2 holds up to
            the rounding slack."""
            x1 = proj.project(s.y - g / lanes(L))
            Ax1 = op.matvec(x1)
            lhs = 0.5 * op.dot(x1, Ax1) + op.dot(x1, b)
            d = x1 - s.y
            rhs = rhs_const + op.dot(g, d) + 0.5 * L * op.dot(d, d)
            return _Trial(x1, Ax1, lhs <= rhs + slack * (lhs.abs() + rhs.abs()))

        L, c = s.L, trial(s.L)
        mv = s.mv + 2
        bt = torch.zeros_like(mv)
        while True:
            again = active & ~c.ok & (mv < budget) & (bt < config.max_backtracks)
            if not any_lane(again):
                break
            L = torch.where(again, L * config.backtrack_grow, L)
            c = select_lanes(again, trial(L), c)
            mv = mv + again
            bt = bt + again
        x1 = c.x1

        # Momentum update (Pospisil 2015 lines 7-8).
        th = s.theta
        th1 = 0.5 * (-th * th + th * torch.sqrt(4 + th * th))
        beta = th * (1 - th) / (th * th + th1)
        y1 = lanes(1 + beta) * x1 - lanes(beta) * s.x
        res = pg_residual(proj, x1, c.Ax1 + b, config.gd, op)
        if config.anti_relaxation:
            better = res < s.resmin
            resmin = torch.where(better, res, s.resmin)
            xhat = where_lanes(better, x1, s.xhat)
            # Momentum restart on non-monotone progress (Mazhar lines 25-28).
            restart = op.dot(g, x1 - s.x) > 0
            y1 = where_lanes(restart, x1, y1)
            th1 = torch.where(restart, 1.0, th1)
        else:
            resmin, xhat = s.resmin, s.xhat
        done = (res < config.tol) | (mv >= budget)
        return _APGDState(x1, y1, th1, L * config.relax, res, mv, s.it + 1, done,
                          resmin, xhat, record_trace(s.trace, s.it, res))

    while True:
        active = ~s.done
        if not any_lane(active):
            break
        s = select_lanes(active, body(s, active), s)
    # APGD-AR reports its best iterate with the last iterate's residual.
    x_out = s.xhat if config.anti_relaxation else s.x
    return make_result(x_out, s.res, s.mv, s.it, budget, s.trace)


def solve_anti_relaxation(A, b, x0=None, proj=None, config: APGDConfig = None):
    """APGD-AR: best-iterate tracking and momentum restart."""
    if config is None:
        config = APGDConfig(anti_relaxation=True)
    elif not config.anti_relaxation:
        config = dataclasses.replace(config, anti_relaxation=True)
    return solve(A, b, x0, proj, config=config)


@dataclasses.dataclass(frozen=True)
class APGDSCConfig(SolverConfig):
    """restart: gradient-mapping momentum restart (O'Donoghue-Candes).

    bound_iters: power iterations of the in-solve spectral-bound fallback,
    used when the operator carries no mu (raw stacks): 2 bound_iters + 2
    matvecs, charged to the budget."""

    restart: bool = True
    bound_iters: int = 32


class _SCState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor          # extrapolated point
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    verifying: torch.Tensor  # a stale-gradient claim awaits a fresh check
    trace: torch.Tensor


def solve_sc(A, b, x0=None, proj=None, config: APGDSCConfig = APGDSCConfig()):
    """Accelerated projected gradient with optimal constant momentum on a
    batch of strongly convex QPs.

    A: ``(B, n, n)`` tensor or operator (``SpectralDense`` carries the
    bounds; any other operator pays the in-solve estimate); b: ``(B, n)``.
    Returns a ``SolveResult``; every converged lane exited on a fresh-gradient
    residual.
    """
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    x0 = default_x0(b, x0, proj)
    B = b.shape[0]
    budget = config.max_matvecs
    L, mu = op.spectral_bounds()
    mv0 = 0
    if mu is None:
        # In-solve estimate through op.matvec, charged to the budget.
        v0 = torch.ones_like(b) / torch.sqrt(torch.tensor(b.shape[-1], dtype=b.dtype))
        L, mu = power_spectral_bounds(op.matvec, v0, config.bound_iters, dot=op.dot)
        mv0 = 2 * int(config.bound_iters) + 2
    L = L.to(b.dtype)[:, None]
    q = torch.clamp(mu.to(b.dtype)[:, None] / L, 1e-12, 1.0)
    beta = (1 - torch.sqrt(q)) / (1 + torch.sqrt(q))

    x_init = proj.project(x0)
    s = _SCState(x=x_init, y=x_init,
               res=torch.full((B,), torch.inf, dtype=b.dtype, device=b.device),
               mv=torch.full((B,), mv0, dtype=torch.int32, device=b.device),
               it=torch.zeros(B, dtype=torch.int32, device=b.device),
               done=torch.full((B,), mv0 >= budget, device=b.device),
               verifying=torch.zeros(B, dtype=torch.bool, device=b.device),
               trace=init_trace(config, B, b.dtype, b.device))

    sargs = fused_set_args(op, b, proj, config.trace_len)
    if sargs is not None:
        s = _sc_loop_fused(op, b, s, proj, L, beta, sargs, config)
    else:
        s = _sc_loop_eager(op, b, s, proj, L, beta, config)
    # converged := mv < max keeps unverified budget-edge claims honest; every
    # done_v exit carries a fresh-gradient residual.
    return make_result(s.x, s.res, s.mv, s.it, budget, s.trace)


def _sc_body(s, op, b, proj, L, beta, config, Av=None):
    """One eager iteration of ``solve_sc`` on every lane (the caller keeps
    the done lanes' state): the plain version of ``ops.sc_step``.  ``Av``
    is the sweep ``A where(verifying, x, y)`` when the caller has taken it."""
    ver = s.verifying[:, None]
    if Av is None:
        Av = op.matvec(torch.where(ver, s.x, s.y))   # the one sweep
    g = Av + b
    mv = s.mv + 1
    x1 = proj.project(s.y - g / L)
    x1v = proj.project(s.x - g / L)                  # resume step on a failed claim
    res = pg_residual(proj, torch.where(ver, s.x, x1), g, config.gd, op)
    if config.restart:
        b_eff = torch.where((op.dot(s.y - x1, x1 - s.x) > 0)[:, None], 0.0, beta)
    else:
        b_eff = beta
    done_v = s.verifying & (res < config.tol)
    x_next = torch.where(done_v[:, None], s.x, torch.where(ver, x1v, x1))
    y_next = torch.where(ver, x_next, x1 + b_eff * (x1 - s.x))
    done = done_v | (mv >= config.max_matvecs)
    verifying = ~s.verifying & (res < config.tol) & ~done
    return _SCState(x_next, y_next, res, mv, s.it + 1, done, verifying,
                    record_trace(s.trace, s.it, res))


def _sc_loop_eager(op, b, s, proj, L, beta, config, Av=None):
    """``solve_sc``'s loop with the eager body; ``Av``, when given, is the
    first iteration's sweep."""
    global SC_STEPS_EAGER
    while True:
        active = ~s.done
        if not any_lane(active):
            break
        s = select_lanes(active, _sc_body(s, op, b, proj, L, beta, config, Av), s)
        Av = None
        SC_STEPS_EAGER += 1
    return s


def _sc_loop_fused(op, b, s, proj, L, beta, sargs, config):
    """``solve_sc``'s loop with the fused step: a GEMV on ``v``, the step
    kernel, and the "any lane left?" test an iteration.  Every field of the
    state is updated in place; x and y, which start as one tensor (a start
    shared by the lanes may be ``(n,)``), are copied to ``(B, n)`` first.
    An ``A v`` in another dtype than b goes to the eager loop, with the
    state as it stands."""
    global SC_STEPS_FUSED
    x = s.x.expand(b.shape).clone(memory_format=torch.contiguous_format)
    s = s._replace(x=x, y=x.clone())
    v = x.clone()                                    # no lane verifies at the start
    L = L.contiguous()
    while any_lane(~s.done):
        Av = op.matvec(v)
        if Av.dtype != b.dtype:
            return _sc_loop_eager(op, b, s, proj, L, beta, config, Av)
        sc_step.step(sargs, Av.contiguous(), b, s.x, s.y, v, s.res, s.mv, s.it, s.done,
                     s.verifying, L, beta, tol=config.tol, gd=config.gd,
                     budget=config.max_matvecs, restart=config.restart)
        SC_STEPS_FUSED += 1
    return s
