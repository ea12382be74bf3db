"""Port parity: ccqppy_tpu_torch.models.pcg against ccqppy_tpu's pcg, f64.

The JAX side is ``solve_batched`` (vmap of the nested while-loops, exact
per lane); the port runs the same batch with explicit lane masks.  The
lanes of each batch take different paths: lane 0's optimum is interior,
the others have many active bounds and need different numbers of
iterations and verification segments.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import mprgp, pcg
from ccqppy_tpu_torch.models.base import SolverConfig
from ccqppy_tpu_torch.ops.projections import Projection
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)


def wishart_box_batch(B, n, seed, scale=3.0):
    """A = G G^T + n I; b = -A x_uncon with x_uncon ~ U(-scale, scale), so
    most lanes have many active bounds on [-1, 1]; lane 0 is interior."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    xu = rng.uniform(-scale, scale, (B, n))
    xu[0] = rng.uniform(-0.5, 0.5, n)
    return A, -np.einsum("bij,bj->bi", A, xu)


def both(A, b, jproj, jcfg, x0=None):
    rj = solve_batched("pcg", jnp.asarray(A), jnp.asarray(b),
                       x0=None if x0 is None else jnp.asarray(x0),
                       proj=jproj, config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = pcg.solve(At, bt, x0=None if x0 is None else torch.from_numpy(x0),
                   proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    return rj, rt


def assert_lanes_match(rj, rt):
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_matches_jax_per_lane(n, precond):
    A, b = wishart_box_batch(8, n, seed=n)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=2000, precond=precond)
    rj, rt = both(A, b, cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64), jcfg)
    assert bool(np.asarray(rj.converged).all())
    assert len(set(np.asarray(rj.matvecs).tolist())) > 2   # lanes differ
    assert_lanes_match(rj, rt)


@pytest.mark.parametrize("kind", ["identity", "lower", "upper"])
def test_other_polyhedral_sets_match_jax(kind):
    n = 48
    A, b = wishart_box_batch(6, n, seed=7)
    jproj = {"identity": cq.identity(),
             "lower": cq.lower_bound(-np.ones(n), dtype=jnp.float64),
             "upper": cq.upper_bound(np.ones(n), dtype=jnp.float64)}[kind]
    rj, rt = both(A, b, jproj, JaxPCGConfig(tol=1e-8, max_matvecs=2000))
    assert_lanes_match(rj, rt)


def test_warm_start_and_trace_match_jax():
    n = 64
    A, b = wishart_box_batch(8, n, seed=11)
    x0 = np.random.default_rng(12).uniform(-2, 2, (8, n))   # infeasible: projected
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=2000, trace_len=12)
    rj, rt = both(A, b, cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64), jcfg, x0)
    assert_lanes_match(rj, rt)
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-6,
                               atol=1e-12)


def test_budget_exhaustion_matches_jax():
    n = 64
    A, b = wishart_box_batch(8, n, seed=3)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=12)
    rj, rt = both(A, b, cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64), jcfg)
    assert not bool(np.asarray(rj.converged)[1:].any())
    assert int(rt.matvecs.max()) <= 12
    assert_lanes_match(rj, rt)


def test_batch_equals_lanes_alone():
    """Per-lane results do not depend on the other lanes of the batch."""
    n = 40
    A, b = wishart_box_batch(5, n, seed=5)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    proj = proj_from_jax(cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64))
    cfg = pcg.PCGConfig(tol=1e-8, max_matvecs=2000)
    r = pcg.solve(At, bt, proj=proj, config=cfg)
    for i in range(5):
        ri = pcg.solve(At[i:i + 1], bt[i:i + 1], proj=proj, config=cfg)
        assert int(ri.matvecs[0]) == int(r.matvecs[i])
        np.testing.assert_allclose(ri.x[0].numpy(), r.x[i].numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_curved_set_not_ported():
    """A set that is not polyhedral no longer raises: pcg delegates to
    fused MPRGP-BB with its tolerance, budget, gd and trace length."""
    class Curved(Projection):
        def project(self, x):
            return x

        def max_feasible_step(self, x, p):
            return torch.full(x.shape[:-1], torch.inf, dtype=x.dtype)

    A, b = wishart_box_batch(2, 8, seed=0)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    cfg = pcg.PCGConfig(tol=1e-9, max_matvecs=300, trace_len=5, refresh_every=7)
    r = pcg.solve(At, bt, proj=Curved(), config=cfg)
    r_mb = mprgp.solve_bb(At, bt, proj=Curved(),
                          config=mprgp.MPRGPBBConfig(tol=1e-9, max_matvecs=300, trace_len=5))
    assert bool(r.converged.all())
    for f in ("x", "residual", "matvecs", "iterations", "trace"):
        assert torch.equal(getattr(r, f), getattr(r_mb, f))


def test_config_carries_over_field_for_field():
    jcfg = JaxPCGConfig(tol=3e-7, max_matvecs=77, precond="jacobi", trace_len=4)
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, pcg.PCGConfig) and isinstance(cfg, SolverConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
