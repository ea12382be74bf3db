"""Fixed-step projected gradient descent (PGD), batched.

Port of ``ccqppy_tpu/models/pgd.py``: per iteration
``x <- proj(x - t g); g = A x + b``, one matvec.  Batching as in
``models/pcg.py``: every scalar of the JAX state is a ``(B,)`` tensor, the
host reads one "any lane left?" flag per iteration, and lanes that are done
keep their state through ``select_lanes``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          init_trace, make_result, pg_residual,
                                          record_trace, select_lanes)
from ccqppy_tpu_torch.ops.linop import as_operator
from ccqppy_tpu_torch.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class PGDConfig(SolverConfig):
    """step_size: the fixed step t."""

    step_size: float = 0.01


class _State(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: torch.Tensor


def solve(A, b, x0=None, proj=None, config: PGDConfig = PGDConfig()):
    """Projected gradient with a fixed step on a batch of QPs.

    A: (B, n, n) tensor or operator; b: (B, n); x0: (B, n) or None.
    One matvec at the start, one per iteration.
    """
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    x0 = default_x0(b, x0, proj)
    t, tol, budget = config.step_size, config.tol, config.max_matvecs
    B = b.shape[0]

    g0 = op.matvec(x0) + b
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    s = _State(x0, g0, res0, torch.ones(B, dtype=torch.int32, device=b.device),
               torch.zeros(B, dtype=torch.int32, device=b.device), res0 < tol,
               init_trace(config, B, b.dtype, b.device))

    def body(s):
        x = proj.project(s.x - t * s.g)
        g = op.matvec(x) + b
        mv = s.mv + 1
        res = pg_residual(proj, x, g, config.gd, op)
        done = (res < tol) | (mv >= budget)
        return _State(x, g, res, mv, s.it + 1, done, record_trace(s.trace, s.it, res))

    while True:
        active = ~s.done
        if not any_lane(active):
            break
        s = select_lanes(active, body(s), s)
    return make_result(s.x, s.res, s.mv, s.it, budget, s.trace)
