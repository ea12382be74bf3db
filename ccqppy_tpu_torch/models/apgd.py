"""Strong-convexity accelerated projected gradient (``solve_sc``), batched.

Port of ``APGDSCConfig`` and ``solve_sc`` from ``ccqppy_tpu/models/apgd.py``
(see that module for the algorithm and its measurements).  With spectral
bounds L >= lambda_max and mu <= lambda_min per lane, the schedule is a
fixed step 1/L with constant momentum beta = (1 - sqrt(q)) / (1 + sqrt(q)),
q = clip(mu / L): one matvec per iteration, no backtracking.

Verified convergence: the gradient of an iteration is fresh at the
extrapolated point y, so the residual at the new iterate is a claim; a
``verifying`` iteration spends its matvec on ``A x`` and only a fresh
residual below tol may exit.  A failed claim resumes with a plain prox step
from x.  Momentum restarts (O'Donoghue-Candes) when the prox-gradient
direction opposes the momentum.

Batching as in ``models/pcg.py``: lanes are the leading axis, every scalar
of the JAX state is a ``(B,)`` tensor, lanes that are done keep their state
through ``torch.where``, and the host reads one "any lane left?" flag per
iteration.

The classic ``apgd`` and ``apgd_ar`` (backtracking Nesterov) are not ported
yet (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, default_x0, init_trace,
                                          make_result, pg_residual,
                                          record_trace, select_lanes)
from ccqppy_tpu_torch.ops.linop import as_operator, power_spectral_bounds
from ccqppy_tpu_torch.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class APGDSCConfig(SolverConfig):
    """restart: gradient-mapping momentum restart (O'Donoghue-Candes).

    bound_iters: power iterations of the in-solve spectral-bound fallback,
    used when the operator carries no mu (raw stacks): 2 bound_iters + 2
    matvecs, charged to the budget."""

    restart: bool = True
    bound_iters: int = 32


class _State(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor          # extrapolated point
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    verifying: torch.Tensor  # a stale-gradient claim awaits a fresh check
    trace: torch.Tensor


def _not_ported(*args, **kwargs):
    raise NotImplementedError("classic APGD and APGD-AR (backtracking Nesterov) are "
                              "not ported yet (ROADMAP queue 1 item 11)")


solve = solve_anti_relaxation = _not_ported


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
        L, mu = power_spectral_bounds(op.matvec, v0, config.bound_iters)
        mv0 = 2 * int(config.bound_iters) + 2
    L = L.to(b.dtype)[:, None]
    q = torch.clamp(mu.to(b.dtype)[:, None] / L, 1e-12, 1.0)
    beta = (1 - torch.sqrt(q)) / (1 + torch.sqrt(q))

    x_init = proj.project(x0)
    s = _State(x=x_init, y=x_init,
               res=torch.full((B,), torch.inf, dtype=b.dtype, device=b.device),
               mv=torch.full((B,), mv0, dtype=torch.int32, device=b.device),
               it=torch.zeros(B, dtype=torch.int32, device=b.device),
               done=torch.full((B,), mv0 >= budget, device=b.device),
               verifying=torch.zeros(B, dtype=torch.bool, device=b.device),
               trace=init_trace(config, B, b.dtype, b.device))

    def body(s):
        ver = s.verifying[:, None]
        g = op.matvec(torch.where(ver, s.x, s.y)) + b    # the one sweep
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
        done = done_v | (mv >= budget)
        verifying = ~s.verifying & (res < config.tol) & ~done
        return _State(x_next, y_next, res, mv, s.it + 1, done, verifying,
                      record_trace(s.trace, s.it, res))

    while True:
        active = ~s.done
        if not bool(active.any()):
            break
        s = select_lanes(active, body(s), s)
    # converged := mv < max keeps unverified budget-edge claims honest; every
    # done_v exit carries a fresh-gradient residual.
    return make_result(s.x, s.res, s.mv, s.it, budget, s.trace)
