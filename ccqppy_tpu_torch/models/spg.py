"""Spectral projected gradient for QP (SPG-QP), batched.

Port of ``SPGConfig`` and ``solve`` from ``ccqppy_tpu/models/spg.py``
(Pospisil 2018 Alg. 5; see that module for the design notes).

* Two init matvecs: ``g0 = A x0 + b``, then ``A g0`` for the first
  spectral step ``alpha0 = g.g / g.Ag``; each iteration does one, ``A d``.
* The GLL nonmonotone memory is a ``(B, m)`` ring per lane, -inf where
  empty, with ``f0`` in slot 0 and a per-lane write position.
* The step ``betak = sigma1 + (min(betahat, sigma2) - sigma1) u`` draws
  ``u`` from ``draw(keys, it)``, by default ``utils.rng.uniform``: a
  function of each lane's key and its own iteration, so a lane's stream
  follows it through compaction.  Its values differ from the JAX package's
  threefry stream; the parity tests pass JAX's uniforms through ``draw``.
* Faithful quirks kept: the surrogate starts at ``f0 = g.x0``, and its
  update uses ``betak^2`` on the linear term.
* ``criterion="eq25"`` (default) stops on the Eq. 25 residual of the
  CARRIED gradient ``g``, updated as ``g + betak A d`` without a fresh
  matvec, as the JAX package does; ``"d_norm"`` on ``||d||``.
* On the iteration that ends a lane, x, g, f, the ring and alpha keep their
  values, while the ring position, ``it``, ``res`` and ``mv`` advance.

Batching as in ``models/pcg.py``: every scalar of the JAX state is a
``(B,)`` tensor, the host reads one "any lane left?" flag per iteration,
and lanes that are done keep their state through ``select_lanes``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          init_trace, lanes, make_result,
                                          pg_residual, record_trace,
                                          select_lanes, where_lanes)
from ccqppy_tpu_torch.ops.linop import as_operator
from ccqppy_tpu_torch.ops.projections import identity
from ccqppy_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class SPGConfig(SolverConfig):
    """m / tau / sigma1 / sigma2: the GLL memory length, the safeguard
    parameter and the interval of the randomised step.

    criterion: "eq25" (the Eq. 25 residual, default) or "d_norm" (the
    reference's ``||d_k|| <= tol``, which can report convergence far from
    the optimum when the step collapses)."""

    m: int = 5
    tau: float = 0.5
    sigma1: float = 0.01
    sigma2: float = 0.5
    criterion: str = "eq25"


class _State(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor
    f: torch.Tensor
    alpha: torch.Tensor
    fq: torch.Tensor      # (B, m) ring of surrogate objective values
    fq_pos: torch.Tensor
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: torch.Tensor


def solve(A, b, x0=None, proj=None, config: SPGConfig = SPGConfig(), keys=None,
          draw=None):
    """SPG-QP on a batch of QPs: A (B, n, n) tensor or operator, b (B, n),
    x0 (B, n) or None.

    keys: ``(B,)`` int64 per-lane seeds (default ``rng.split_keys(0, B)``).
    draw: ``draw(keys, it) -> (B,)`` uniforms in [0, 1) for each lane's
    iteration ``it`` (default ``rng.uniform``)."""
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    if config.criterion not in ("eq25", "d_norm"):
        raise ValueError(f"criterion must be 'eq25' or 'd_norm', not {config.criterion!r}")
    x0 = default_x0(b, x0, proj)
    B, m = b.shape[0], config.m
    keys = rng.split_keys(0, B, b.device) if keys is None else rng.check_keys(keys, B, b.device)
    draw = draw if draw is not None else (lambda k, it: rng.uniform(k, it, b.dtype))
    tol, budget = config.tol, config.max_matvecs

    g0 = op.matvec(x0) + b
    f0 = op.dot(g0, x0)
    alpha0 = op.dot(g0, g0) / op.dot(g0, op.matvec(g0))
    fq0 = torch.full((B, m), -torch.inf, dtype=b.dtype, device=b.device)
    fq0[:, 0] = f0
    slot = torch.arange(m, device=b.device)
    s = _State(x=x0, g=g0, f=f0, alpha=alpha0, fq=fq0,
               fq_pos=torch.ones(B, dtype=torch.int32, device=b.device),
               res=torch.full((B,), torch.inf, dtype=b.dtype, device=b.device),
               mv=torch.full((B,), 2, dtype=torch.int32, device=b.device),
               it=torch.zeros(B, dtype=torch.int32, device=b.device),
               done=torch.zeros(B, dtype=torch.bool, device=b.device),
               trace=init_trace(config, B, b.dtype, b.device))

    def body(s):
        d = proj.project(s.x - lanes(s.alpha) * s.g) - s.x
        Ad = op.matvec(d)
        mv = s.mv + 1
        dd = op.dot(d, d)
        dAd = op.dot(d, Ad)
        dg = op.dot(d, s.g)
        if config.criterion == "eq25":
            res = pg_residual(proj, s.x, s.g, config.gd, op)
        else:
            res = torch.sqrt(dd)
        done = (res <= tol) | (mv >= budget)

        # Safeguarded nonmonotone step (Pospisil 2018 lines 9-18).
        xi = (s.fq.amax(dim=-1) - s.f) / dAd
        beta = -dg / dAd
        betahat = config.tau * beta + torch.sqrt(
            torch.clamp(config.tau**2 * beta**2 + 2 * xi, min=0))
        hi = torch.clamp(betahat, max=config.sigma2)
        betak = config.sigma1 + (hi - config.sigma1) * draw(keys, s.it).to(b.dtype)

        x = s.x + lanes(betak) * d
        g = s.g + lanes(betak) * Ad
        f = s.f + betak * betak * dg + 0.5 * betak**2 * dAd
        fq = torch.where(slot == (s.fq_pos % m)[:, None], f[:, None], s.fq)
        alpha = dd / dAd
        # The iteration that ends a lane reports the point it started from.
        keep = ~done
        return _State(where_lanes(keep, x, s.x), where_lanes(keep, g, s.g),
                      torch.where(keep, f, s.f), torch.where(keep, alpha, s.alpha),
                      where_lanes(keep, fq, s.fq), s.fq_pos + 1, res, mv,
                      s.it + 1, done, record_trace(s.trace, s.it, res))

    while True:
        active = ~s.done
        if not any_lane(active):
            break
        s = select_lanes(active, body(s), s)
    return make_result(s.x, s.res, s.mv, s.it, budget, s.trace)
