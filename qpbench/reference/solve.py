"""A plain projected-gradient solver, the reference answer of a lane.

For ``min 1/2 x^T A x + b^T x`` over a set, A symmetric positive definite:
``x <- P(x - t (A x + b))`` with ``t = 2 / (L + mu)``, L and mu the
extreme eigenvalues of each lane's A by power iteration.  The map
contracts by ``(L - mu) / (L + mu)`` a step (the projection does not
expand), so the iterates converge to the one optimum whatever the start.
It runs until every lane's Eq. 25 residual is at most ``tol`` and raises if
one is not there by ``max_iter``.  Plain ``torch.bmm`` in the dtype of A
(f64 for the reference; the control passes a matvec of its own).
"""
from __future__ import annotations

import torch

from qpbench.reference import sets

POWER_ITERS = 40
CHECK_EVERY = 10


def bmv(A, x):
    """Per lane ``A x``: (B, n) for A (B, n, n), x (B, n)."""
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def _dot(u, v):
    return (u * v).sum(-1)


def extreme_eigenvalues(matvec, like, iters=POWER_ITERS):
    """Per lane (lambda_max, lambda_min) estimates by power iteration on A and
    on ``c I - A`` (c = 1.05 lambda_max), from the unit vector of ones."""
    n = like.shape[-1]
    v0 = torch.full_like(like, 1.0 / n ** 0.5)

    def top(apply):
        v = v0
        for _ in range(iters):
            w = apply(v)
            v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        return _dot(v, apply(v))

    lmax = top(matvec)
    c = 1.05 * lmax
    return lmax, c - top(lambda v: c[:, None] * v - matvec(v))


def step_size(matvec, like):
    """``2 / (L + mu)`` per lane, (B, 1)."""
    lmax, lmin = extreme_eigenvalues(matvec, like)
    return (2.0 / (lmax + lmin))[:, None]


def solve(A, b, spec, gd, tol=1e-10, max_iter=20_000):
    """The reference optimum of every lane: (x, residual, iterations) for
    A (B, n, n), b (B, n) in the dtype of A."""
    return projected_gradient(lambda v: bmv(A, v), b, spec, gd, tol, max_iter)


def projected_gradient(matvec, b, spec, gd, tol, max_iter, iters=None, t=None):
    """Projected gradient from ``P(0)`` with ``matvec``: until every lane's
    Eq. 25 residual is at most ``tol`` (checked every ``CHECK_EVERY`` steps;
    raises past ``max_iter``), or exactly ``iters`` steps when given.  The
    step ``t`` (B, 1) is worked out by ``step_size`` unless given."""
    if t is None:
        t = step_size(matvec, b)
    x = sets.project(spec, torch.zeros_like(b))
    it = 0
    while True:
        g = matvec(x) + b
        if iters is None and it % CHECK_EVERY == 0:
            res = sets.pg_residual(spec, x, g, gd)
            if bool((res <= tol).all()):
                return x, res, it
            if it >= max_iter:
                raise RuntimeError(f"reference solve left {int((res > tol).sum())} lanes above "
                                   f"{tol:g} after {it} steps (max residual {float(res.max()):.3e})")
        if iters is not None and it == iters:
            return x, sets.pg_residual(spec, x, g, gd), it
        x = sets.project(spec, x - t * g)
        it += 1
