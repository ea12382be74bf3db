"""The constraint sets of the configurations, and the Eq. 25 residual.

``box``: ``{x : lower <= x <= upper}``.  ``lorentz_blocks``: the points are
cut into contiguous blocks of ``block_dim``; each block ``(u, z)``, z its
LAST coordinate, lies in the second-order cone ``||u|| <= mu z``.  Its
projection (Moreau's three cases): inside, the point; in the polar cone
(``mu ||u|| <= -z``), 0; else ``t = (mu ||u|| + z) / (mu^2 + 1)`` and
``(t mu u / ||u||, t)``.

The Eq. 25 residual (Mazhar et al. 2015) of a point x with gradient
``g = A x + b``: ``||x - P(x - gd g)|| / (3 n gd)``, a norm per lane.  On
the box the formula is exact as written.  On a cone it is taken in its
closed form, the limit gd -> 0, block by block: ``g`` inside, ``g`` less
its inward-pushing normal part ``min(<nrm, g>, 0) nrm`` on the surface
(``nrm`` the outward unit normal), ``-P(-g)`` at the apex.  A block is on
the surface when ``|mu z - ||u||| <= atol + rtol |mu z|`` and at the apex
when ``||(u, z)|| <= atol`` (the tolerances of numpy's ``isclose``, which
the configurations state); a block outside the cone beyond that band
takes the formula as written, whose ``1 / gd`` makes it read far above
any tolerance.
"""
from __future__ import annotations

import torch


def project(spec, x):
    """P(x) onto the configuration's set ``spec``, for x (..., n)."""
    kind = spec["kind"]
    if kind == "box":
        return torch.clamp(x, float(spec["lower"]), float(spec["upper"]))
    if kind == "lorentz_blocks":
        d, mu = int(spec["block_dim"]), float(spec["mu"])
        blocks = x.unflatten(-1, (-1, d))
        u, z = blocks[..., :-1], blocks[..., -1]
        un = torch.linalg.vector_norm(u, dim=-1)
        t = (mu * un + z) / (mu * mu + 1.0)
        scale = torch.where(un > 0, t * mu / torch.where(un > 0, un, 1.0), 0.0)
        on_u, on_z = scale[..., None] * u, t
        inside = un <= mu * z
        polar = mu * un <= -z
        pu = torch.where(inside[..., None], u, torch.where(polar[..., None], 0.0, on_u))
        pz = torch.where(inside, z, torch.where(polar, 0.0, on_z))
        return torch.cat([pu, pz[..., None]], dim=-1).flatten(-2)
    raise ValueError(f"unknown set {kind!r}")


RTOL, ATOL = 1e-5, 1e-8


def pg_residual(spec, x, g, gd, rtol=RTOL, atol=ATOL):
    """Eq. 25 residual per lane: (B,) for x, g (B, n)."""
    if spec["kind"] == "lorentz_blocks":
        r = _cone_residual(spec, x, g, gd, rtol, atol)
    else:
        r = (x - project(spec, x - gd * g)) / gd
    return torch.linalg.vector_norm(r, dim=-1) / (3.0 * x.shape[-1])


def _cone_residual(spec, x, g, gd, rtol, atol):
    d, mu = int(spec["block_dim"]), float(spec["mu"])
    xb, gb = x.unflatten(-1, (-1, d)), g.unflatten(-1, (-1, d))
    u, z = xb[..., :-1], xb[..., -1]
    un = torch.linalg.vector_norm(u, dim=-1)
    band = atol + rtol * torch.abs(mu * z)
    apex = torch.linalg.vector_norm(xb, dim=-1) <= atol
    surface = ~apex & (torch.abs(mu * z - un) <= band)
    outside = ~apex & (un - mu * z > band)
    udir = u / torch.where(un > 0, un, 1.0)[..., None]
    nrm = torch.cat([udir, torch.full_like(z, -mu)[..., None]], dim=-1) / (1.0 + mu * mu) ** 0.5
    ng = (nrm * gb).sum(-1, keepdim=True)
    on_surface = gb - torch.clamp(ng, max=0.0) * nrm
    at_apex = -project(spec, -g).unflatten(-1, (-1, d))
    written = ((x - project(spec, x - gd * g)) / gd).unflatten(-1, (-1, d))
    r = torch.where(apex[..., None], at_apex,
                    torch.where(surface[..., None], on_surface,
                                torch.where(outside[..., None], written, gb)))
    return r.flatten(-2)

