"""Port parity: the curved sets and compositions of
ccqppy_tpu_torch.ops.projections against ccqppy_tpu's, f64.

The port's methods take (B, n) points and reduce per lane (per block
inside a blockwise or segment set); the JAX methods are vmapped over the
same points.  XLA contracts products and sums into fused multiply-adds, so
the two agree to rounding, not bit for bit: every comparison is at 1e-14
relative.  One quantity is not continuous at that level: the feasible step
from a point within rounding of the cone or sphere hinges on the rounding
of mu^2 z^2 - ||u||^2, and such steps (below 1e-13) agree to 1e-13 absolute.
Segment and product compositions of the port run the same arithmetic and
are held to bitwise equality, as the JAX package's own test holds them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.utils.convert import proj_from_jax

torch.set_num_threads(1)

B, NBLK = 9, 12
GD = 1e-6
EPS = np.finfo(np.float64).eps
RTOL, STEP_ATOL = 1e-14, 1e-13


def _cone_points(rng, mu, nblk=NBLK):
    """(B, nblk, 3) points, each block one of: inside, polar, exactly on the
    surface (u = (3, 4) s, z = 5 s / mu, s a power of two: every product is
    exact), at the apex, a few ulp inside or outside the surface, or
    anywhere.  ``mu`` is a scalar or (nblk,)."""
    mu = np.broadcast_to(np.asarray(mu, dtype=np.float64), (nblk,))
    kind = rng.integers(0, 7, (B, nblk))
    kind.reshape(-1)[:7] = np.arange(7)             # every kind occurs
    u = rng.standard_normal((B, nblk, 2))
    un = np.linalg.norm(u, axis=-1)
    s = 2.0 ** rng.integers(-3, 4, (B, nblk))
    surf_u = np.stack([3 * s, 4 * s], -1)
    surf_z = 5 * s / mu
    ulps = rng.integers(1, 6, (B, nblk)) * EPS
    z = np.select([kind == 0, kind == 1, kind == 2, kind == 4, kind == 5],
                  [un / mu * rng.uniform(1.2, 3, (B, nblk)),
                   -mu * un * rng.uniform(1.2, 3, (B, nblk)),
                   surf_z, surf_z * (1 + ulps), surf_z * (1 - ulps)],
                  rng.standard_normal((B, nblk)))
    u = np.where(np.isin(kind, (2, 4, 5))[..., None], surf_u, u)
    x = np.concatenate([u, z[..., None]], -1)
    x[kind == 3] = 0.0
    return x, kind


def _directions(rng, shape):
    p = rng.standard_normal(shape)
    p[rng.random(shape[:-1]) < 0.1] = 0.0            # whole zero steps
    return p


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _vm(f, *a):
    return np.asarray(jax.vmap(f)(*map(jnp.asarray, a)))


def _check_all_methods(jp, tp, x, g, xf, p):
    """Every method of the port against the vmapped JAX method: at ``x``
    (any point) and at the feasible ``xf``, with gradients ``g`` and steps
    ``p``."""
    xt, gt, xft, pt = (torch.tensor(a) for a in (x, g, xf, p))
    for pts, ptsj in ((xt, x), (xft, xf)):
        _close(tp.project(pts), _vm(jp.project, ptsj))
        _close(tp(pts), _vm(jp.project, ptsj))
        _close(tp.normal(pts), _vm(jp.normal, ptsj))
        for t, j in zip(tp.free_chopped(pts, gt), jax.vmap(jp.free_chopped)(ptsj, g)):
            _close(t, j, atol=1e-15)
        _close(tp.pg_residual_vec(pts, gt, GD),
               _vm(lambda a, b: jp.pg_residual_vec(a, b, GD), ptsj, g), atol=1e-15)
        np.testing.assert_array_equal(tp.contains(pts).numpy(), _vm(jp.contains, ptsj))
        np.testing.assert_array_equal(tp.binding_mask(pts, gt).numpy(),
                                      _vm(jp.binding_mask, ptsj, g))
        _close(tp.snap_binding(pts, gt), _vm(jp.snap_binding, ptsj, g))
    _close(tp.max_feasible_step(xft, pt), _vm(jp.max_feasible_step, xf, p),
           atol=STEP_ATOL)
    assert tp.polyhedral == jp.polyhedral


@pytest.mark.parametrize("mu", [1.0, 0.5, 2.0])
def test_lorentz_cone_matches_jax(mu):
    rng = np.random.default_rng(int(mu * 10))
    x, kind = _cone_points(rng, mu, nblk=1)
    x = x[:, 0]
    jp = JP.lorentz_cone(mu, dtype=jnp.float64)
    tp = proj_from_jax(jp)
    assert isinstance(tp, P.LorentzConeProj) and not tp.polyhedral
    xf = x.copy()
    infeasible = np.isin(kind[:, 0], (1, 5, 6))
    xf[infeasible] = np.asarray(jax.vmap(jp.project)(jnp.asarray(x[infeasible])))
    _check_all_methods(jp, tp, x, rng.standard_normal(x.shape), xf,
                       _directions(rng, x.shape))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tp.is_apex(xt).numpy(), _vm(jp.is_apex, x))
    np.testing.assert_array_equal(tp.is_active(xt).numpy(), _vm(jp.is_active, x))


@pytest.mark.parametrize("per_block", [False, True])
def test_blockwise_cone_matches_jax(per_block):
    """Shared mu, and one mu per block (child_axes=0), over B lanes of
    NBLK blocks, every kind of point in every lane."""
    rng = np.random.default_rng(3 + per_block)
    # Powers of two keep the exact surface points exact.
    mu = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0], NBLK) if per_block else 0.5
    x, kind = _cone_points(rng, mu)
    child = JP.LorentzConeProj(jnp.asarray(mu, jnp.float64))
    jp = JP.blockwise(child, 3, child_axes=0 if per_block else None)
    tp = proj_from_jax(jp)
    assert tp.child_axes == (0 if per_block else None)
    x = x.reshape(B, -1)
    xf = np.asarray(jax.vmap(jp.project)(jnp.asarray(x)))
    feasible = ~np.isin(kind, (1, 5, 6)).repeat(3, axis=1)
    xf = np.where(feasible, x, xf)   # keep exact surface, apex and inside points
    _check_all_methods(jp, tp, x, rng.standard_normal(x.shape), xf,
                       _directions(rng, x.shape))


def test_blockwise_box_per_block_matches_jax():
    rng = np.random.default_rng(5)
    lb = rng.uniform(-2.0, -0.1, (NBLK, 3))
    ub = rng.uniform(0.1, 2.0, (NBLK, 3))
    jp = JP.blockwise(JP.BoxProj(jnp.asarray(lb), jnp.asarray(ub)), 3, child_axes=0)
    tp = proj_from_jax(jp)
    assert tp.polyhedral
    x = rng.uniform(-3, 3, (B, 3 * NBLK))
    on = rng.random(x.shape) < 0.3
    x = np.where(on, np.where(rng.random(x.shape) < 0.5, lb.reshape(-1), ub.reshape(-1)), x)
    xf = np.asarray(jax.vmap(jp.project)(jnp.asarray(x)))
    _check_all_methods(jp, tp, x, rng.standard_normal(x.shape), xf,
                       _directions(rng, x.shape))


@pytest.mark.parametrize("center", [0.0, 0.25])
def test_ball_matches_jax(center):
    """Inside, outside, exactly on the sphere (3-4-5 points), a few ulp
    inside it, and at the centre."""
    rng = np.random.default_rng(7)
    radius, n = 5.0, 3
    x = rng.standard_normal((24, n)) * 4
    x[:6] = np.array([3.0, 4.0, 0.0]) * rng.choice([-1, 1], (6, n)) + center
    x[6:12] = (np.array([0.0, 3.0, 4.0]) * (1 - rng.integers(1, 6, (6, 1)) * EPS)) + center
    x[12] = center
    jp = JP.ball(radius, center, dtype=jnp.float64)
    tp = proj_from_jax(jp)
    xf = np.array(jax.vmap(jp.project)(jnp.asarray(x)))
    xf[:13] = x[:13]
    _check_all_methods(jp, tp, x, rng.standard_normal(x.shape), xf,
                       _directions(rng, x.shape))


def _mixed_blocks(J, dt, seed=3, num_cones=5, num_boxes=4):
    """Interleaved cone / box / identity blocks with their own parameters,
    the composition of the JAX package's test_segment_matches_product."""
    rng = np.random.default_rng(seed)
    blocks = []
    for i in range(max(num_cones, num_boxes)):
        if i < num_cones:
            blocks.append((J.lorentz_cone(float(rng.uniform(0.5, 1.5)), dtype=dt), 3))
        if i < num_boxes:
            blocks.append((J.box(rng.uniform(-2, 0, 2), rng.uniform(0.5, 2, 2), dtype=dt), 2))
        if i == 1:
            blocks.append((J.identity(), 2))
    return blocks


@pytest.mark.parametrize("kind", ["segment", "product"])
def test_compositions_match_jax(kind):
    jblocks = _mixed_blocks(JP, jnp.float64)
    jp = JP.segment_product(*jblocks) if kind == "segment" else JP.ProductProj.make(*jblocks)
    tp = proj_from_jax(jp)
    n = sum(d for _, d in jblocks)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, n)) * 2
    xf = np.asarray(jax.vmap(jp.project)(jnp.asarray(x)))
    _check_all_methods(jp, tp, x, rng.standard_normal(x.shape), xf,
                       _directions(rng, x.shape))


def test_segment_matches_product_bitwise():
    """segment_product groups the blocks (3 groups: cone, box, identity)
    and computes exactly what the unrolled product computes."""
    blocks = _mixed_blocks(P, torch.float64)
    seg, prod = P.segment_product(*blocks), P.ProductProj(*blocks)
    assert len(seg.parts) == 3 and seg.counts == (5, 4, 1) and seg.dims == (3, 2, 2)
    n = sum(d for _, d in blocks)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((20, n)) * 2)
    g = torch.from_numpy(rng.standard_normal((20, n)))
    xf = prod.project(x)

    def same(a, b):
        assert torch.equal(a, b)

    same(seg.project(x), prod.project(x))
    same(seg.normal(x), prod.normal(x))
    for a, b in zip(seg.free_chopped(x, g), prod.free_chopped(x, g)):
        same(a, b)
    same(seg.binding_mask(x, g), prod.binding_mask(x, g))
    same(seg.snap_binding(xf, g), prod.snap_binding(xf, g))
    same(seg.max_feasible_step(xf, g), prod.max_feasible_step(xf, g))
    same(seg.pg_residual_vec(x, g, GD), prod.pg_residual_vec(x, g, GD))
    same(seg.contains(x), prod.contains(x))
    assert seg.polyhedral == prod.polyhedral is False


def test_blockwise_per_block_matches_segment_bitwise():
    """A blockwise box with one bound pair per block equals the segment
    composition of the same boxes, bit for bit."""
    rng = np.random.default_rng(13)
    nblk, bd = 40, 3
    lb = torch.from_numpy(rng.uniform(-2.0, -0.1, (nblk, bd)))
    ub = torch.from_numpy(rng.uniform(0.1, 2.0, (nblk, bd)))
    bw = P.blockwise(P.BoxProj(lb, ub), bd, child_axes=0)
    seg = P.segment_product(*[(P.BoxProj(lb[i], ub[i]), bd) for i in range(nblk)])
    assert len(seg.parts) == 1 and seg.parts[0].lb.shape == (nblk, bd)
    x = torch.from_numpy(rng.uniform(-3, 3, (10, nblk * bd)))
    g = torch.from_numpy(rng.standard_normal((10, nblk * bd)))
    xf = bw.project(x)
    for name in ("project", "normal", "contains"):
        assert torch.equal(getattr(bw, name)(x), getattr(seg, name)(x))
    for name in ("binding_mask", "snap_binding", "max_feasible_step"):
        assert torch.equal(getattr(bw, name)(xf, g), getattr(seg, name)(xf, g))
    assert torch.equal(bw.pg_residual_vec(x, g, GD), seg.pg_residual_vec(x, g, GD))


def test_segment_rejects_a_non_permutation():
    cone = P.lorentz_cone(1.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="permutation"):
        P.SegmentProj([cone, cone], [torch.arange(3), torch.arange(2, 5)], [3, 3])
    with pytest.raises(ValueError, match="whole blocks"):
        P.SegmentProj([cone], [torch.arange(4)], [3])


def test_take_gathers_lane_parameters():
    """take(idx) gathers every parameter along its lane axis, through the
    children of a composition, and leaves a segment's coordinates alone."""
    lb = torch.arange(12.0).reshape(4, 3)
    bw = P.blockwise(P.BoxProj(lb[:, None, :], lb[:, None, :] + 1), 3)
    t = bw.take(torch.tensor([2, 0]))
    assert torch.equal(t.child.lb[:, 0], lb[[2, 0]]) and bw.child.lb.shape == (4, 1, 3)
    seg = P.segment_product((P.LorentzConeProj(torch.ones(4)), 3),
                            (P.BoxProj(lb, lb + 1), 3))
    t = seg.take(torch.tensor([3]))
    assert torch.equal(t.perm, seg.perm) and t.parts[1].lb.shape == (1, 3)
    assert sorted(k for k, _ in seg.parameter_buffers()) == ["group0.mu", "group1.lb",
                                                            "group1.ub"]


def test_cone_feasible_step_is_exact():
    """From points strictly inside the cone, x - a p stays in it for every a
    up to max_feasible_step and leaves it just beyond, when the step is
    finite.  (On the surface the JAX package's step depends on the sign of
    the rounded mu^2 z^2 - ||u||^2; ROADMAP queue 3.)"""
    rng = np.random.default_rng(15)
    cone = P.blockwise(P.lorentz_cone(0.7, dtype=torch.float64), 3)
    x = cone.project(torch.from_numpy(rng.standard_normal((200, 9))))
    x = x + torch.tensor([0.0, 0.0, 0.05] * 3, dtype=torch.float64)
    p = torch.from_numpy(rng.standard_normal((200, 9)))
    a = cone.max_feasible_step(x, p)
    assert bool((a >= 0).all())
    for frac in (0.0, 0.5, 0.999):
        assert bool(cone.contains(x - (a.clamp(max=1e6) * frac)[:, None] * p).all())
    finite = torch.isfinite(a) & (a > 1e-9)
    beyond = x - (a * 1.01)[:, None] * p
    assert not bool(cone.contains(beyond)[finite].any())
