"""Barzilai-Borwein projected gradient descent (BBPGD) and its fallback
variant (BBPGDf), batched.

Port of ``ccqppy_tpu/models/bbpgd.py`` (Yan 2019 Alg. 1; Pospisil 2015b
Alg. 5).  Per iteration: one matvec, one projection, three dot products.

* Every operator application is counted, the initial BB step
  ``alpha0 = g.g / g.Ag`` included, so a solve starts at 2 matvecs.
* ``precond="jacobi"`` runs the iteration in the diag(A) metric: steps
  ``x <- proj(x - alpha D^-1 g)`` and the BB1 step in the scaled inner
  product; the stopping residual stays the unscaled Eq. 25 one.
* BBPGDf tracks the best iterate and, when ``alpha < 10 eps``, restarts from
  ``proj(xmin - gd gmin)``.  The restart keeps the stale gradient ``g`` of
  the step it replaces, as the JAX package (and its reference) does; the
  next BB step heals it.

Batching as in ``models/pcg.py``: every scalar of the JAX state is a
``(B,)`` tensor, the host reads one "any lane left?" flag per iteration,
and lanes that are done keep their state through ``select_lanes``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          eps_of, init_trace, lanes,
                                          make_result, pg_residual,
                                          record_trace, select_lanes,
                                          where_lanes)
from ccqppy_tpu_torch.ops.linop import as_operator
from ccqppy_tpu_torch.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class BBPGDConfig(SolverConfig):
    """precond: "none" or "jacobi" (the diag(A) metric; exact for
    separable sets, whose D-metric projection is still a clip)."""

    precond: str = "none"


@dataclasses.dataclass(frozen=True)
class BBPGDfConfig(BBPGDConfig):
    pass


class _State(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    # best-iterate tracking (BBPGDf; carried unchanged by BBPGD)
    resmin: torch.Tensor
    xmin: torch.Tensor
    gmin: torch.Tensor
    trace: torch.Tensor


def _solve(A, b, x0, proj, config, fallback):
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    if config.precond not in ("none", "jacobi"):
        raise ValueError(f"precond must be 'none' or 'jacobi', not {config.precond!r}")
    x0 = default_x0(b, x0, proj)
    if config.precond == "jacobi":
        diag = op.diagonal()
        dinv = 1.0 / diag
    else:
        diag = dinv = None
    tiny = eps_of(b)
    tol, budget = config.tol, config.max_matvecs
    B = b.shape[0]

    g0 = op.matvec(x0) + b
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    # Initial BB step; in the Jacobi metric the scaled Rayleigh quotient
    # (g.D^-1 g) / (D^-1 g . A D^-1 g).
    s0g = dinv * g0 if dinv is not None else g0
    gAg = op.dot(s0g, op.matvec(s0g))
    num = op.dot(g0, s0g)
    s = _State(x=x0, g=g0, alpha=num / gAg, res=res0,
               mv=torch.full((B,), 2, dtype=torch.int32, device=b.device),
               it=torch.zeros(B, dtype=torch.int32, device=b.device), done=res0 < tol,
               resmin=torch.full_like(res0, torch.inf), xmin=x0, gmin=g0,
               trace=init_trace(config, B, b.dtype, b.device))

    def body(s):
        step_dir = dinv * s.g if dinv is not None else s.g
        x = proj.project(s.x - lanes(s.alpha) * step_dir)
        g = op.matvec(x) + b
        mv = s.mv + 1
        res = pg_residual(proj, x, g, config.gd, op)
        done = (res < tol) | (mv >= budget)
        if fallback:
            better = res < s.resmin
            resmin = torch.where(better, res, s.resmin)
            xmin = where_lanes(better, x, s.xmin)
            gmin = where_lanes(better, g, s.gmin)
            # On step-size stagnation restart from the best point with a tiny
            # projected-gradient step; g stays the stale gradient (see the
            # module docstring).
            x = where_lanes(s.alpha < tiny, proj.project(xmin - config.gd * gmin), x)
        else:
            resmin, xmin, gmin = s.resmin, s.xmin, s.gmin
        # BB1 step dx.dx / (dx.dg + 10 eps); dx.D dx in the Jacobi metric.
        dx = x - s.x
        dg = g - s.g
        num = op.dot(dx, diag * dx) if diag is not None else op.dot(dx, dx)
        alpha = num / (op.dot(dx, dg) + tiny)
        return _State(x, g, alpha, res, mv, s.it + 1, done, resmin, xmin, gmin,
                      record_trace(s.trace, s.it, res))

    while True:
        active = ~s.done
        if not any_lane(active):
            break
        s = select_lanes(active, body(s), s)
    return make_result(s.x, s.res, s.mv, s.it, budget, s.trace)


def solve(A, b, x0=None, proj=None, config: BBPGDConfig = BBPGDConfig()):
    """BBPGD (Yan 2019 Alg. 1) on a batch of QPs: A (B, n, n) tensor or
    operator, b (B, n), x0 (B, n) or None."""
    return _solve(A, b, x0, proj, config, fallback=False)


def solve_fallback(A, b, x0=None, proj=None, config: BBPGDfConfig = BBPGDfConfig()):
    """BBPGD with the stagnation fallback (Pospisil 2015b Alg. 5)."""
    return _solve(A, b, x0, proj, config, fallback=True)
