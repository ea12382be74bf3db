"""Projection operators for polyhedral feasible sets, batched in PyTorch.

Port of the polyhedral half of ``ccqppy_tpu/ops/projections.py``: the
``Projection`` interface, ``IdentityProj``, ``LowerBoundProj``,
``UpperBoundProj`` and ``BoxProj``.  Semantics are those of the JAX
package, method for method (see its module docstring for why they differ
from upstream CCQPpy).

Differences of form, not of meaning:

* Points carry an explicit leading batch dimension ``(B, n)`` in place of
  ``vmap``.  Every reduction (``max_feasible_step``'s min, the norms of
  ``contains`` and ``free_chopped``'s dots) runs over the last dimension
  only, so each lane gets its own value: ``(B,)`` for a ``(B, n)`` input.
* Bounds are buffers of an ``nn.Module``, so ``.to(device)`` moves them.
  They broadcast against the points: shape ``(n,)`` for bounds shared by
  every lane, ``(B, n)`` for per-lane bounds.
"""
from __future__ import annotations

import torch
from torch import nn

# Active-set detection tolerances, mirroring numpy.isclose defaults used by the
# upstream library.  |x - bound| <= ATOL + RTOL * |bound|.
ACTIVE_RTOL = 1e-5
ACTIVE_ATOL = 1e-8


def _near(x, ref):
    """Elementwise ``isclose(x, ref)`` with the upstream tolerances."""
    return torch.abs(x - ref) <= ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(ref)


def _at_bound(x, ref):
    """Tight at-bound test for ``binding_mask``: a projection lands iterates
    *exactly* on the bound, so only a few-ulp band is needed -- a wide band
    (``_near``) would freeze genuinely interior coordinates and stall the
    ``pcg`` face solver."""
    band = 16 * torch.finfo(x.dtype).eps * (1 + torch.abs(ref))
    return torch.abs(x - ref) <= band


def _safe_div(num, den, fallback):
    """num / den where den != 0, else fallback (no NaN generation)."""
    den_ok = den != 0
    safe = torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, num / safe, fallback)


class Projection(nn.Module):
    """Interface for projections onto closed convex sets.

    * ``project(x)``              -- Euclidean projection onto the set.
    * ``normal(x)``               -- outward (sub)normal at the active
                                     boundary, zero for interior points.
    * ``free_chopped(x, g)``      -- MPRGP free / chopped gradient split.
    * ``max_feasible_step(x, p)`` -- per lane, the largest a >= 0 with
                                     x - a p feasible.
    * ``binding_mask(x, g)``      -- 1 where a coordinate may move in a
                                     face-restricted step, 0 where it binds.
    * ``snap_binding(x, g)``      -- binding coordinates placed exactly on
                                     their bound.
    * ``pg_residual_vec(x, g, gd)`` -- stable (x - project(x - gd g)) / gd.
    * ``contains(x)``             -- per-lane feasibility predicate.

    Calling the module projects.
    """

    #: True when the set is an intersection of axis-aligned half-spaces,
    #: so that ``max_feasible_step`` and ``binding_mask`` are exact.  The
    #: ``pcg`` face solver requires it.
    polyhedral = False

    def forward(self, x):
        return self.project(x)

    def project(self, x):
        raise NotImplementedError

    def normal(self, x):
        return torch.zeros_like(x)

    def free_chopped(self, x, g):
        """Default split via the outward normal, per lane.

        free    = g on the inactive part, tangential part on the active
                  smooth boundary.
        chopped = max(0, n.g) n  -- the KKT-violating outward component.
        """
        n = self.normal(x)
        ng = (n * g).sum(-1, keepdim=True)
        nn_ = (n * n).sum(-1, keepdim=True)
        active = nn_ > 0
        coef = _safe_div(ng, nn_, torch.zeros_like(ng))
        chopped = torch.where(active & (ng > 0), coef, 0.0) * n
        free = torch.where(active, g - coef * n, g)
        return free, chopped

    def max_feasible_step(self, x, p):
        raise NotImplementedError

    def binding_mask(self, x, g):
        """Per-coordinate indicator (dtype of x) of coordinates free to move
        in a face-restricted step from feasible ``x`` with gradient ``g``.
        Default (sound for any set): freeze every coordinate the outward
        normal touches.  Separable sets override with the exact test."""
        n = self.normal(self.project(x))
        return (n == 0).to(x.dtype)

    def snap_binding(self, x, g):
        """Place every coordinate that ``binding_mask`` binds EXACTLY on its
        bound (a CG-limited step can stop inside the 16-ulp band of a bound
        and would otherwise freeze there).  Default: no snap."""
        return x

    def pg_residual_vec(self, x, g, gd):
        """(x - project(x - gd*g)) / gd, literal fallback, rearranged as
        ``g + (u - project(u)) / gd`` with ``u = x - gd*g``."""
        u = x - gd * g
        return g + (u - self.project(u)) / gd

    def contains(self, x):
        return torch.linalg.vector_norm(x - self.project(x), dim=-1) <= \
            ACTIVE_ATOL + ACTIVE_RTOL * torch.linalg.vector_norm(x, dim=-1)


class IdentityProj(Projection):
    """All of R^n."""

    polyhedral = True

    def project(self, x):
        return x

    def free_chopped(self, x, g):
        return g, torch.zeros_like(g)

    def binding_mask(self, x, g):
        return torch.ones_like(x)

    def max_feasible_step(self, x, p):
        return torch.full(x.shape[:-1], torch.inf, dtype=x.dtype,
                          device=x.device)

    def pg_residual_vec(self, x, g, gd):
        return g

    def contains(self, x):
        return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


class LowerBoundProj(Projection):
    """{x : x >= lb}."""

    polyhedral = True

    def __init__(self, lb):
        super().__init__()
        self.register_buffer("lb", torch.as_tensor(lb))

    def project(self, x):
        return torch.maximum(x, self.lb)

    def is_active(self, x):
        return _near(x, self.lb)

    def normal(self, x):
        return torch.where(self.is_active(self.project(x)), -1.0, 0.0).to(x.dtype)

    def free_chopped(self, x, g):
        active = self.is_active(x)
        free = torch.where(active, 0.0, g)
        chopped = torch.where(active, torch.clamp(g, max=0), 0.0)
        return free, chopped

    def binding_mask(self, x, g):
        # Bound binds iff at the bound AND the gradient pushes outward
        # (descent -g would decrease x below lb).
        return torch.where(_at_bound(x, self.lb) & (g > 0), 0.0, 1.0).to(x.dtype)

    def snap_binding(self, x, g):
        return torch.where(_at_bound(x, self.lb) & (g > 0),
                           self.lb.to(x.dtype), x)

    def max_feasible_step(self, x, p):
        # x - a p >= lb  =>  for p_i > 0: a <= (x_i - lb_i) / p_i.
        gap = torch.clamp(x - self.lb, min=0)
        ratio = torch.where(p > 0, _safe_div(gap, p, torch.inf), torch.inf)
        return ratio.amin(dim=-1)

    def pg_residual_vec(self, x, g, gd):
        # Exact: (x - max(x - gd g, lb)) / gd == min(g, (x - lb)/gd).
        return torch.minimum(g, (x - self.lb) / gd)

    def contains(self, x):
        return (x >= self.lb - (ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(self.lb))).all(dim=-1)


class UpperBoundProj(Projection):
    """{x : x <= ub}."""

    polyhedral = True

    def __init__(self, ub):
        super().__init__()
        self.register_buffer("ub", torch.as_tensor(ub))

    def project(self, x):
        return torch.minimum(x, self.ub)

    def is_active(self, x):
        return _near(x, self.ub)

    def normal(self, x):
        return torch.where(self.is_active(self.project(x)), 1.0, 0.0).to(x.dtype)

    def free_chopped(self, x, g):
        active = self.is_active(x)
        free = torch.where(active, 0.0, g)
        chopped = torch.where(active, torch.clamp(g, min=0), 0.0)
        return free, chopped

    def binding_mask(self, x, g):
        return torch.where(_at_bound(x, self.ub) & (g < 0), 0.0, 1.0).to(x.dtype)

    def snap_binding(self, x, g):
        return torch.where(_at_bound(x, self.ub) & (g < 0),
                           self.ub.to(x.dtype), x)

    def max_feasible_step(self, x, p):
        gap = torch.clamp(self.ub - x, min=0)
        ratio = torch.where(p < 0, _safe_div(gap, -p, torch.inf), torch.inf)
        return ratio.amin(dim=-1)

    def pg_residual_vec(self, x, g, gd):
        return torch.maximum(g, (x - self.ub) / gd)

    def contains(self, x):
        return (x <= self.ub + (ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(self.ub))).all(dim=-1)


class BoxProj(Projection):
    """{x : lb <= x <= ub}.  A coordinate is active iff at (or beyond)
    either bound."""

    polyhedral = True

    def __init__(self, lb, ub):
        super().__init__()
        self.register_buffer("lb", torch.as_tensor(lb))
        self.register_buffer("ub", torch.as_tensor(ub))

    def project(self, x):
        return torch.clamp(x, self.lb, self.ub)

    def active_lower(self, x):
        return _near(x, self.lb) | (x < self.lb)

    def active_upper(self, x):
        return _near(x, self.ub) | (x > self.ub)

    def normal(self, x):
        xp = self.project(x)
        n = torch.where(_near(xp, self.ub), 1.0, 0.0) - \
            torch.where(_near(xp, self.lb), 1.0, 0.0)
        return n.to(x.dtype)

    def free_chopped(self, x, g):
        lo = self.active_lower(x)
        hi = self.active_upper(x)
        free = torch.where(lo | hi, 0.0, g)
        chopped = torch.where(lo, torch.clamp(g, max=0), 0.0) + \
            torch.where(hi, torch.clamp(g, min=0), 0.0)
        return free, chopped

    def binding_mask(self, x, g):
        blocked = (_at_bound(x, self.lb) & (g > 0)) | \
                  (_at_bound(x, self.ub) & (g < 0))
        return torch.where(blocked, 0.0, 1.0).to(x.dtype)

    def snap_binding(self, x, g):
        x = torch.where(_at_bound(x, self.lb) & (g > 0), self.lb.to(x.dtype), x)
        return torch.where(_at_bound(x, self.ub) & (g < 0), self.ub.to(x.dtype), x)

    def max_feasible_step(self, x, p):
        gap_lo = torch.clamp(x - self.lb, min=0)
        gap_hi = torch.clamp(self.ub - x, min=0)
        r_lo = torch.where(p > 0, _safe_div(gap_lo, p, torch.inf), torch.inf)
        r_hi = torch.where(p < 0, _safe_div(gap_hi, -p, torch.inf), torch.inf)
        return torch.minimum(r_lo, r_hi).amin(dim=-1)

    def pg_residual_vec(self, x, g, gd):
        # Exact closed form: (x - clip(x - gd g, lb, ub)) / gd
        #                  == clip(g, (x - ub)/gd, (x - lb)/gd).
        return torch.clamp(g, (x - self.ub) / gd, (x - self.lb) / gd)

    def contains(self, x):
        tol_l = ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(self.lb)
        tol_u = ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(self.ub)
        return ((x >= self.lb - tol_l) & (x <= self.ub + tol_u)).all(dim=-1)


def box(lb, ub, dtype=torch.float32, device=None):
    return BoxProj(torch.as_tensor(lb, dtype=dtype, device=device),
                   torch.as_tensor(ub, dtype=dtype, device=device))


def lower_bound(lb, dtype=torch.float32, device=None):
    return LowerBoundProj(torch.as_tensor(lb, dtype=dtype, device=device))


def upper_bound(ub, dtype=torch.float32, device=None):
    return UpperBoundProj(torch.as_tensor(ub, dtype=dtype, device=device))


def identity():
    return IdentityProj()
