"""Projection operators for convex feasible sets, batched in PyTorch.

Port of ``ccqppy_tpu/ops/projections.py``: the ``Projection`` interface,
the polyhedral sets (``IdentityProj``, ``LowerBoundProj``,
``UpperBoundProj``, ``BoxProj``), the curved sets (``BallProj``,
``LorentzConeProj``) and the compositions (``BlockwiseProj``,
``ProductProj``, ``SegmentProj`` built by ``segment_product``).  Semantics
are those of the JAX package, method for method (see its module docstring
for why they differ from upstream CCQPpy).

Differences of form, not of meaning:

* Points carry an explicit leading batch dimension ``(B, n)`` in place of
  ``vmap``.  Every reduction (``max_feasible_step``'s min, the norms of
  ``contains`` and ``free_chopped``'s dots) runs over the last dimension
  only, so each lane gets its own value: ``(B,)`` for a ``(B, n)`` input.
  A curved set takes ``(..., d)`` and reduces to ``(...)``, so the same
  class serves a whole vector and the ``(B, nblk, d)`` blocks of a
  blockwise set.
* Parameters are buffers of an ``nn.Module``, so ``.to(device)`` moves
  them.  They broadcast against the points as the method sees them:
  bounds of shape ``(n,)`` are shared by every lane, ``(B, n)`` are per
  lane; inside a blockwise set, ``(d,)`` is shared by every block and
  ``(nblk, d)`` is per block (``(nblk,)`` for a cone's ``mu``), which is
  what the JAX package's ``child_axes`` selects with ``vmap``.
* ``take(idx)`` gathers every parameter along a leading lane axis, for
  projections whose parameters carry one (``proj_batched`` in
  ``parallel.batch``).
* ``shard(lo, hi, n)`` cuts every coordinate-sized parameter to one rank's
  rows of a row-sharded solve (``parallel.sharded``), where the JAX package
  shards the projection's leaves with ``shard_map``'s ``in_specs``; a set
  that couples coordinates across shards raises.
"""
from __future__ import annotations

import copy
import itertools

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


def _norm(v):
    """Euclidean norm over the last axis, summed as ``jnp.linalg.norm``."""
    return torch.sqrt((v * v).sum(-1))


def _min_positive_root(a, b, c):
    """Smallest t >= 0 with a t^2 + b t + c < 0 just beyond it, else +inf,
    elementwise.  Assumes q(0) = c >= 0 (the start point is feasible).  Used
    for the exact max-feasible-step of the ball and the Lorentz cone."""
    inf = torch.inf
    # Linear case a == 0: q crosses zero at -c/b when b < 0.
    lin = torch.where(b < 0, _safe_div(-c, b, inf), inf)
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0))
    # a > 0: q is negative strictly between r1 <= r2.  a < 0: c >= 0 implies
    # disc >= 0, and q < 0 beyond the larger root.
    r1 = _safe_div(-b - sq, 2 * a, inf)
    r2 = _safe_div(-b + sq, 2 * a, inf)
    pos_up = torch.where(disc <= 0, inf, torch.where(r1 >= 0, r1, inf))
    pos_down = torch.clamp(torch.maximum(r1, r2), min=0)
    quad = torch.where(a > 0, pos_up, pos_down)
    return torch.where(a == 0, lin, quad)


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

    #: Buffers that index coordinates rather than parameterize the set;
    #: ``take`` and ``parameter_buffers`` leave them alone.
    _structural = frozenset()

    def parameter_buffers(self):
        """(name, buffer) of every parameter, here and in the child sets."""
        for prefix, m in self.named_modules():
            for k, v in m._buffers.items():
                if v is not None and k not in m._structural:
                    yield (f"{prefix}.{k}" if prefix else k), v

    def take(self, idx):
        """The projection for lanes ``idx``: every parameter buffer, here
        and in the child sets, is gathered along its leading lane axis."""
        new = copy.copy(self)
        new._buffers = {k: v if v is None or k in self._structural
                        else v.index_select(0, idx)
                        for k, v in self._buffers.items()}
        new._modules = {k: m.take(idx) for k, m in self._modules.items()}
        return new

    #: True when the set acts on each coordinate alone, so that the rows
    #: [lo, hi) of a point are projected by the set on those coordinates.
    separable = False

    def shard(self, lo, hi, n):
        """The set on coordinates [lo, hi) of n, for one rank of a
        row-sharded solve (``parallel.sharded``): every parameter buffer
        whose last axis has n entries is cut to [lo, hi), the others are
        shared.  A set that couples coordinates across shards raises."""
        if not self.separable:
            raise ValueError(
                f"{type(self).__name__} couples coordinates across shards: a row-sharded "
                "solve takes a separable set (box, bounds, identity) or a blockwise one "
                "whose blocks align with the shard boundaries")
        new = copy.copy(self)
        new._buffers = {k: v[..., lo:hi] if v is not None and v.dim() and v.shape[-1] == n
                        else v for k, v in self._buffers.items()}
        return new


class IdentityProj(Projection):
    """All of R^n."""

    polyhedral = True
    separable = True

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
    separable = True

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
    separable = True

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
    separable = True

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


class BallProj(Projection):
    """{x : ||x - center|| <= radius} over the last axis.  ``radius`` is
    scalar or has the reduced shape (per lane, per block); ``center``
    broadcasts against the points."""

    def __init__(self, radius, center):
        super().__init__()
        self.register_buffer("radius", torch.as_tensor(radius))
        self.register_buffer("center", torch.as_tensor(center))

    def project(self, x):
        y = x - self.center
        nrm = _norm(y)
        scale = torch.where(nrm > self.radius,
                            _safe_div(self.radius, nrm, torch.ones_like(nrm)), 1.0)
        return self.center + scale[..., None] * y

    def is_active(self, x):
        nrm = _norm(x - self.center)
        return nrm >= self.radius - (ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(self.radius))

    def normal(self, x):
        y = self.project(x) - self.center
        unit = _safe_div(y, _norm(y)[..., None], torch.zeros_like(y))
        return torch.where(self.is_active(x)[..., None], unit, 0.0)

    def free_chopped(self, x, g):
        # Tangential truncation for either gradient sign at the active
        # sphere (see the JAX package's Projection.free_chopped).
        n = self.normal(x)
        ng = (n * g).sum(-1)
        active = self.is_active(x)[..., None]
        free = torch.where(active, g - ng[..., None] * n, g)
        chopped = torch.where(active, torch.clamp(ng, min=0)[..., None], 0.0) * n
        return free, chopped

    def max_feasible_step(self, x, p):
        # q(t) = ||(x - t p) - c||^2 - r^2 must stay <= 0; flip the signs
        # into _min_positive_root's q >= 0 convention.
        y = x - self.center
        a = (p * p).sum(-1)
        b = -2 * (y * p).sum(-1)
        c = (y * y).sum(-1) - self.radius**2
        return _min_positive_root(-a, -b, -c)

    def pg_residual_vec(self, x, g, gd):
        """Cancellation-free gd -> 0 limit: g inside, g - min(<n, g>, 0) n on
        the active sphere."""
        n = self.normal(x)
        ng = (n * g).sum(-1)
        return torch.where(self.is_active(x)[..., None],
                           g - torch.clamp(ng, max=0)[..., None] * n, g)

    def contains(self, x):
        r = self.radius
        return _norm(x - self.center) <= r + (ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(r))


class LorentzConeProj(Projection):
    """Second-order cone {(u, z) : ||u|| <= mu z}, z the LAST coordinate of
    the last axis.  Moreau's three cases:

        inside  (||u|| <=  mu z) -> x
        polar   (mu ||u|| <= -z) -> 0
        else    t = (mu ||u|| + z) / (mu^2 + 1);  proj = (t mu u/||u||, t)

    ``mu`` is scalar or has the reduced shape, e.g. ``(nblk,)`` per block.
    """

    def __init__(self, mu):
        super().__init__()
        self.register_buffer("mu", torch.as_tensor(mu))

    @staticmethod
    def _split(x):
        return x[..., :-1], x[..., -1]

    def project(self, x):
        u, z = self._split(x)
        mu = self.mu
        un = _norm(u)
        inside = (un <= mu * z)[..., None]
        polar = (mu * un <= -z)[..., None]
        t = (mu * un + z) / (mu * mu + 1)
        udir = _safe_div(u, un[..., None], torch.zeros_like(u))
        out_u = torch.where(inside, u, torch.where(polar, 0.0, (t * mu)[..., None] * udir))
        out_z = torch.where(inside, z[..., None], torch.where(polar, 0.0, t[..., None]))
        return torch.cat([out_u, out_z], dim=-1)

    def is_active(self, x):
        u, z = self._split(x)
        slack = self.mu * z - _norm(u)
        return slack <= ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(self.mu * z)

    def is_apex(self, x):
        # Absolute threshold, as in the JAX package.
        return _norm(x) <= ACTIVE_ATOL

    def normal(self, x):
        """Outward unit normal on the cone surface; zero inside and at the
        apex."""
        xp = self.project(x)
        u, _ = self._split(xp)
        mu = self.mu
        un = _norm(u)
        udir = _safe_div(u, un[..., None], torch.zeros_like(u))
        denom = torch.sqrt(1 + mu * mu)
        zpart = torch.broadcast_to(-mu / denom, u.shape[:-1])[..., None]
        n = torch.cat([udir / denom[..., None], zpart], dim=-1)
        active = self.is_active(xp) & ~self.is_apex(xp)
        return torch.where(active[..., None], n, 0.0)

    def free_chopped(self, x, g):
        n = self.normal(x)
        ng = (n * g).sum(-1)
        apex = self.is_apex(x)[..., None]
        on_surface = (self.is_active(x)[..., None]) & ~apex
        free_surface = torch.where(on_surface, g - ng[..., None] * n, g)
        chop_surface = torch.where(on_surface, torch.clamp(ng, min=0)[..., None] * n, 0.0)
        # Apex: optimal iff project(-g) == 0; the violation is the feasible
        # descent component -project(-g).
        free = torch.where(apex, 0.0, free_surface)
        chopped = torch.where(apex, -self.project(-g), chop_surface)
        return free, chopped

    def max_feasible_step(self, x, p):
        u, z = self._split(x)
        pu, pz = self._split(p)
        mu2 = self.mu * self.mu
        # q(t) = mu^2 (z - t pz)^2 - ||u - t pu||^2 >= 0 and z - t pz >= 0.
        qa = mu2 * pz * pz - (pu * pu).sum(-1)
        qb = -2 * mu2 * z * pz + 2 * (u * pu).sum(-1)
        qc = mu2 * z * z - (u * u).sum(-1)
        root = _min_positive_root(qa, qb, qc)
        zcap = torch.where(pz > 0, _safe_div(z, pz, torch.inf), torch.inf)
        return torch.minimum(root, zcap)

    def pg_residual_vec(self, x, g, gd):
        """Cancellation-free closed form: -project(-g) at the apex (exact
        for any gd by positive homogeneity), g - min(<n, g>, 0) n on the
        surface, g inside."""
        n = self.normal(x)
        ng = (n * g).sum(-1)
        surf = g - torch.clamp(ng, max=0)[..., None] * n
        apex = self.is_apex(x)[..., None]
        on_surface = self.is_active(x)[..., None] & ~apex
        out = torch.where(on_surface, surf, g)
        return torch.where(apex, -self.project(-g), out)

    def contains(self, x):
        u, z = self._split(x)
        mz = self.mu * z
        return _norm(u) <= mz + (ACTIVE_ATOL + ACTIVE_RTOL * torch.abs(mz))


class BlockwiseProj(Projection):
    """Cartesian power of one set over contiguous blocks of ``block_dim``:
    the points are viewed as ``(..., nblk, block_dim)`` and the child runs
    once on all blocks.  ``child_axes`` records how the child's parameters
    are laid out: ``None``, shared by every block (``(d,)`` or scalar);
    ``0``, one per block (``(nblk, d)``, or ``(nblk,)`` for a cone's
    ``mu``).  Broadcasting serves both."""

    def __init__(self, child, block_dim, child_axes=None):
        super().__init__()
        if child_axes not in (None, 0):
            raise ValueError(f"child_axes must be None or 0, not {child_axes!r}")
        self.child = child
        self.block_dim = int(block_dim)
        self.child_axes = child_axes

    @property
    def polyhedral(self):
        return self.child.polyhedral

    def _blocks(self, x):
        return x.unflatten(-1, (-1, self.block_dim))

    def _map(self, method, x, *extra):
        out = getattr(self.child, method)(self._blocks(x), *map(self._blocks, extra))
        return out.flatten(-2)

    def project(self, x):
        return self._map("project", x)

    def normal(self, x):
        return self._map("normal", x)

    def free_chopped(self, x, g):
        free, chopped = self.child.free_chopped(self._blocks(x), self._blocks(g))
        return free.flatten(-2), chopped.flatten(-2)

    def binding_mask(self, x, g):
        return self._map("binding_mask", x, g)

    def snap_binding(self, x, g):
        return self._map("snap_binding", x, g)

    def max_feasible_step(self, x, p):
        return self.child.max_feasible_step(self._blocks(x), self._blocks(p)).amin(dim=-1)

    def pg_residual_vec(self, x, g, gd):
        return self.child.pg_residual_vec(self._blocks(x), self._blocks(g), gd).flatten(-2)

    def contains(self, x):
        return self.child.contains(self._blocks(x)).all(dim=-1)

    def shard(self, lo, hi, n):
        """The blocks within [lo, hi), which must start and end on block
        boundaries; per-block child parameters (``child_axes=0``) are cut to
        those blocks, shared ones are kept."""
        d = self.block_dim
        if lo % d or hi % d:
            raise ValueError(f"blocks of {d} cross the shard boundaries [{lo}, {hi}): a "
                             "row-sharded solve needs blocks aligned with the shards")
        new = copy.copy(self)
        buf = next(self.child.buffers(), None)
        if self.child_axes == 0 and buf is not None:
            blocks = torch.arange(lo // d, hi // d, device=buf.device)
            new._modules = {"child": self.child.take(blocks)}
        return new


class ProductProj(Projection):
    """Cartesian product of sets over contiguous index ranges, one child
    call per range.  ``ProductProj((op, dim), (op, dim), ...)``."""

    def __init__(self, *ops_and_dims):
        super().__init__()
        for i, (op, _) in enumerate(ops_and_dims):
            self.add_module(f"part{i}", op)
        self.dims = tuple(int(d) for _, d in ops_and_dims)

    @property
    def parts(self):
        return tuple(self._modules.values())

    @property
    def polyhedral(self):
        return all(c.polyhedral for c in self.parts)

    def _slices(self, x):
        return x.split(self.dims, dim=-1)

    def _apply(self, method, *args):
        return [getattr(c, method)(*a) for c, *a in zip(self.parts, *map(self._slices, args))]

    def project(self, x):
        return torch.cat(self._apply("project", x), dim=-1)

    def normal(self, x):
        return torch.cat(self._apply("normal", x), dim=-1)

    def free_chopped(self, x, g):
        fc = self._apply("free_chopped", x, g)
        return torch.cat([f for f, _ in fc], dim=-1), torch.cat([c for _, c in fc], dim=-1)

    def binding_mask(self, x, g):
        return torch.cat(self._apply("binding_mask", x, g), dim=-1)

    def snap_binding(self, x, g):
        return torch.cat(self._apply("snap_binding", x, g), dim=-1)

    def max_feasible_step(self, x, p):
        return torch.stack(self._apply("max_feasible_step", x, p), dim=-1).amin(dim=-1)

    def pg_residual_vec(self, x, g, gd):
        return torch.cat([c.pg_residual_vec(xi, gi, gd) for c, xi, gi in
                          zip(self.parts, self._slices(x), self._slices(g))], dim=-1)

    def contains(self, x):
        return torch.stack(self._apply("contains", x), dim=-1).all(dim=-1)


class SegmentProj(Projection):
    """Cartesian product of many blocks, grouped: the blocks of one group
    share a set type and a block size, and the group's child holds their
    parameters stacked along a leading ``count`` axis (or shared, when the
    child is one set).  Every method is, per group, one ``index_select``
    of the group's coordinates, one child call on ``(..., count, dim)``
    and one ``index_copy`` back.  Build with ``segment_product``.

    ``indices[g]`` lists the coordinates of group g, block by block; the
    groups' indices together must be a permutation of ``arange(n)``, since
    every output starts from ``empty_like``.
    """

    _structural = frozenset({"perm"})

    def __init__(self, children, indices, dims):
        super().__init__()
        if not (len(children) == len(indices) == len(dims)):
            raise ValueError("children, indices and dims need one entry per group")
        indices = [torch.as_tensor(i, dtype=torch.int64).reshape(-1) for i in indices]
        perm = torch.cat(indices)
        if not torch.equal(perm.sort().values, torch.arange(perm.numel())):
            raise ValueError("the groups' indices are not a permutation of arange(n)")
        for i, c in enumerate(children):
            if indices[i].numel() % int(dims[i]):
                raise ValueError(f"group {i}: {indices[i].numel()} indices are not "
                                 f"whole blocks of {dims[i]}")
            self.add_module(f"group{i}", c)
        self.register_buffer("perm", perm)
        self.dims = tuple(int(d) for d in dims)
        self.counts = tuple(i.numel() // d for i, d in zip(indices, self.dims))
        self.offsets = (0, *itertools.accumulate(i.numel() for i in indices))

    @property
    def parts(self):
        return tuple(self._modules.values())

    @property
    def polyhedral(self):
        return all(c.polyhedral for c in self.parts)

    def _index(self, g):
        return self.perm[self.offsets[g]:self.offsets[g + 1]]

    def _gather(self, x, g):
        return x.index_select(-1, self._index(g)).unflatten(-1, (self.counts[g], self.dims[g]))

    def _groups(self, method, *args):
        """Per group: (coordinate ids, the child's output on the group)."""
        for g, child in enumerate(self.parts):
            yield self._index(g), getattr(child, method)(*(self._gather(a, g) for a in args))

    def _scatter(self, method, x, *extra):
        out = torch.empty_like(x)
        for idx, y in self._groups(method, x, *extra):
            out.index_copy_(-1, idx, y.flatten(-2))
        return out

    def project(self, x):
        return self._scatter("project", x)

    def normal(self, x):
        return self._scatter("normal", x)

    def free_chopped(self, x, g):
        free, chopped = torch.empty_like(x), torch.empty_like(x)
        for idx, (f, c) in self._groups("free_chopped", x, g):
            free.index_copy_(-1, idx, f.flatten(-2))
            chopped.index_copy_(-1, idx, c.flatten(-2))
        return free, chopped

    def binding_mask(self, x, g):
        return self._scatter("binding_mask", x, g)

    def snap_binding(self, x, g):
        return self._scatter("snap_binding", x, g)

    def max_feasible_step(self, x, p):
        steps = [s.amin(dim=-1) for _, s in self._groups("max_feasible_step", x, p)]
        return torch.stack(steps, dim=-1).amin(dim=-1)

    def pg_residual_vec(self, x, g, gd):
        out = torch.empty_like(x)
        for i, child in enumerate(self.parts):
            r = child.pg_residual_vec(self._gather(x, i), self._gather(g, i), gd)
            out.index_copy_(-1, self._index(i), r.flatten(-2))
        return out

    def contains(self, x):
        oks = [c.all(dim=-1) for _, c in self._groups("contains", x)]
        return torch.stack(oks, dim=-1).all(dim=-1)


def _group_key(op, dim):
    """Blocks share a group when their sets have the same type, block size,
    structure and parameter shapes."""
    return (type(op), dim,
            tuple((name, type(m), getattr(m, "block_dim", None), getattr(m, "child_axes", None))
                  for name, m in op.named_modules()),
            tuple((name, tuple(b.shape), b.dtype) for name, b in op.named_buffers()))


def _stack(ops):
    """One set whose parameters are those of ``ops`` stacked along a new
    leading axis."""
    if any(len(op._modules) for op in ops):
        raise ValueError("segment_product stacks the parameters of sets without "
                         "child sets; use one BlockwiseProj per block instead")
    new = copy.copy(ops[0])
    new._buffers = {k: torch.stack([op._buffers[k] for op in ops])
                    for k in ops[0]._buffers}
    return new


def segment_product(*ops_and_dims):
    """A ``SegmentProj`` from (op, dim) pairs laid out one after another,
    the same call as ``ProductProj``'s.  Blocks of the same set type, block
    size and parameter shapes form a group; a group of several blocks with
    parameters stacks them along a leading axis."""
    groups = {}   # key -> [(position, op, dim), ...], in order of first use
    pos = 0
    for op, dim in ops_and_dims:
        dim = int(dim)
        groups.setdefault(_group_key(op, dim), []).append((pos, op, dim))
        pos += dim
    children, indices, dims = [], [], []
    for members in groups.values():
        dim = members[0][2]
        ops = [op for _, op, _ in members]
        has_params = len(list(ops[0].buffers())) > 0
        children.append(_stack(ops) if len(ops) > 1 and has_params else ops[0])
        indices.append(torch.cat([torch.arange(p, p + dim) for p, _, _ in members]))
        dims.append(dim)
    return SegmentProj(children, indices, dims)


def box(lb, ub, dtype=torch.float32, device=None):
    return BoxProj(torch.as_tensor(lb, dtype=dtype, device=device),
                   torch.as_tensor(ub, dtype=dtype, device=device))


def lower_bound(lb, dtype=torch.float32, device=None):
    return LowerBoundProj(torch.as_tensor(lb, dtype=dtype, device=device))


def upper_bound(ub, dtype=torch.float32, device=None):
    return UpperBoundProj(torch.as_tensor(ub, dtype=dtype, device=device))


def identity():
    return IdentityProj()


def ball(radius, center=0.0, dtype=torch.float32, device=None):
    return BallProj(torch.as_tensor(radius, dtype=dtype, device=device),
                    torch.as_tensor(center, dtype=dtype, device=device))


def lorentz_cone(mu=1.0, dtype=torch.float32, device=None):
    return LorentzConeProj(torch.as_tensor(mu, dtype=dtype, device=device))


def blockwise(child, block_dim, child_axes=None):
    """Cartesian power of ``child`` over contiguous ``block_dim``-sized
    blocks; ``child_axes=0`` marks per-block child parameters (see
    ``BlockwiseProj``)."""
    return BlockwiseProj(child, block_dim, child_axes)
