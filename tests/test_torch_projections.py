"""Port parity: ccqppy_tpu_torch.ops.projections against ccqppy_tpu's, f64.

The port's methods take batched points (B, n) and reduce per lane; the JAX
methods are vmapped over the same points.  These are elementwise ops and
per-lane mins of the same values, so they must agree exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.utils.convert import proj_from_jax

torch.set_num_threads(1)

B, N = 12, 24
GD = 1e-6


def _bounds(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2.0, -0.5, N), rng.uniform(0.5, 2.0, N)


def _points(seed, lb, ub):
    """Points inside, outside, exactly on, and within a few ulp of the
    bounds; gradients and steps of both signs, with exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, (B, N))
    on_lb = rng.random((B, N)) < 0.2
    on_ub = ~on_lb & (rng.random((B, N)) < 0.25)
    x = np.where(on_lb, lb, np.where(on_ub, ub, x))
    near = rng.random((B, N)) < 0.1
    x = np.where(near & on_lb, lb + 4 * np.finfo(np.float64).eps * (1 + np.abs(lb)), x)
    x = np.where(near & on_ub, ub - 2 * np.finfo(np.float64).eps * (1 + np.abs(ub)), x)
    g = rng.standard_normal((B, N))
    g[rng.random((B, N)) < 0.1] = 0.0
    p = rng.standard_normal((B, N))
    p[rng.random((B, N)) < 0.1] = 0.0
    return x, g, p


def _pairs():
    lb, ub = _bounds()
    return {
        "identity": cq.identity(),
        "lower": cq.lower_bound(lb, dtype=jnp.float64),
        "upper": cq.upper_bound(ub, dtype=jnp.float64),
        "box": cq.box(lb, ub, dtype=jnp.float64),
    }


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor) else t,
                                  np.asarray(j))


@pytest.mark.parametrize("name", ["identity", "lower", "upper", "box"])
@pytest.mark.parametrize("feasible", [False, True])
def test_methods_match_jax_exactly(name, feasible):
    jp = _pairs()[name]
    tp = proj_from_jax(jp)
    lb, ub = _bounds()
    x, g, p = _points(1 + feasible, lb, ub)
    if feasible:
        x = np.array(jax.vmap(jp.project)(jnp.asarray(x)))
    xt, gt, pt = map(torch.from_numpy, (x, g, p))
    xj, gj, pj = map(jnp.asarray, (x, g, p))
    vm = lambda f, *a: jax.vmap(f)(*a)  # noqa: E731

    _eq(tp.project(xt), vm(jp.project, xj))
    _eq(tp(xt), vm(jp.project, xj))
    _eq(tp.binding_mask(xt, gt), vm(jp.binding_mask, xj, gj))
    _eq(tp.snap_binding(xt, gt), vm(jp.snap_binding, xj, gj))
    _eq(tp.max_feasible_step(xt, pt), vm(jp.max_feasible_step, xj, pj))
    _eq(tp.pg_residual_vec(xt, gt, GD),
        vm(lambda a, b: jp.pg_residual_vec(a, b, GD), xj, gj))
    _eq(tp.normal(xt), vm(jp.normal, xj))
    free_t, chop_t = tp.free_chopped(xt, gt)
    free_j, chop_j = vm(jp.free_chopped, xj, gj)
    _eq(free_t, free_j)
    _eq(chop_t, chop_j)
    _eq(tp.contains(xt), vm(jp.contains, xj))
    assert tp.polyhedral and jp.polyhedral


def test_max_feasible_step_is_per_lane():
    """A lane whose step is unbounded keeps inf; its neighbours do not
    borrow it (the min runs over the last dimension only)."""
    tp = P.box(-torch.ones(4), torch.ones(4), dtype=torch.float64)
    x = torch.zeros((3, 4), dtype=torch.float64)
    p = torch.tensor([[0.0, 0, 0, 0], [1.0, 0, 0, 0], [0.0, -4, 0, 0]],
                     dtype=torch.float64)
    np.testing.assert_array_equal(tp.max_feasible_step(x, p).numpy(), [np.inf, 1.0, 0.25])
    assert tp.contains(torch.tensor([[0.0, 0, 0, 0], [2.0, 0, 0, 0]],
                                    dtype=torch.float64)).tolist() == [True, False]


def test_box_idempotent_and_feasible():
    lb, ub = _bounds(3)
    tp = P.box(lb, ub, dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(4).uniform(-3, 3, (50, N)))
    p1 = tp.project(x)
    np.testing.assert_array_equal(tp.project(p1).numpy(), p1.numpy())
    assert bool(tp.contains(p1).all())


def test_box_feasible_step_exact():
    """x - a p is feasible for every a up to max_feasible_step, and just
    beyond it infeasible when the step is finite."""
    lb, ub = _bounds(5)
    tp = P.box(lb, ub, dtype=torch.float64)
    rng = np.random.default_rng(6)
    x = tp.project(torch.from_numpy(rng.uniform(-3, 3, (30, N))))
    p = torch.from_numpy(rng.uniform(-1, 1, (30, N)))
    a = tp.max_feasible_step(x, p)
    assert bool((a >= 0).all())
    for frac in (0.0, 0.5, 0.999):
        y = x - (a.clamp(max=1e6) * frac)[:, None] * p
        assert float((y - tp.project(y)).norm(dim=-1).max()) < 1e-6
    finite = torch.isfinite(a) & (a < 1e5)
    y = x - (a * 1.01 + 1e-9)[:, None] * p
    assert bool(((y - tp.project(y)).norm(dim=-1) > 0)[finite].all())


def test_box_snap_lands_exactly_on_bound():
    tp = P.box(-torch.ones(3), torch.ones(3), dtype=torch.float64)
    eps = torch.finfo(torch.float64).eps
    x = torch.tensor([[-1 + 8 * eps, 1 - 8 * eps, 0.5]], dtype=torch.float64)
    g = torch.tensor([[1.0, -1.0, 1.0]], dtype=torch.float64)
    np.testing.assert_array_equal(tp.snap_binding(x, g).numpy(), [[-1.0, 1.0, 0.5]])
    np.testing.assert_array_equal(tp.binding_mask(x, g).numpy(), [[0.0, 0.0, 1.0]])


def test_to_moves_bounds():
    tp = P.box([-1.0, -2.0], [1.0, 2.0], dtype=torch.float64).to(torch.float32)
    assert tp.lb.dtype == torch.float32 and tp.ub.dtype == torch.float32


def test_base_defaults_match_jax():
    """The interface's default methods (used by sets that do not override
    them), on a clip set with a boundary normal, against JAX's defaults."""
    from ccqppy_tpu.ops.projections import Projection as JaxProjection

    class JaxClip(JaxProjection):
        def project(self, x):
            return jnp.clip(x, -1.0, 1.0)

        def normal(self, x):
            return jnp.where(jnp.abs(self.project(x)) == 1.0, jnp.sign(x), 0.0)

    class Clip(P.Projection):
        def project(self, x):
            return torch.clamp(x, -1.0, 1.0)

        def normal(self, x):
            return torch.where(self.project(x).abs() == 1.0, torch.sign(x), 0.0)

    x, g, _ = _points(7, -np.ones(N), np.ones(N))
    x[0] = np.clip(x[0], -0.9, 0.9)                      # an interior lane
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    jp, tp = JaxClip(), Clip()
    _eq(tp.binding_mask(xt, gt), jax.vmap(jp.binding_mask)(xj, gj))
    _eq(tp.snap_binding(xt, gt), xt)
    _eq(tp.contains(xt), jax.vmap(jp.contains)(xj))
    np.testing.assert_allclose(tp.pg_residual_vec(xt, gt, GD).numpy(),
                               np.asarray(jax.vmap(lambda a, b: jp.pg_residual_vec(a, b, GD))(xj, gj)),
                               rtol=1e-12, atol=1e-9)
    # free_chopped reduces per lane: equal up to the order of summation.
    for t, j in zip(tp.free_chopped(xt, gt), jax.vmap(jp.free_chopped)(xj, gj)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-15)
    assert not tp.polyhedral
