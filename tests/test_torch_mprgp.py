"""Port parity: ccqppy_tpu_torch.models.mprgp against ccqppy_tpu's, f64.

The families are those of the JAX package's
test_mprgp_fused_matches_unfused: A = G G^T + n I at B=32, n=60, tol 1e-6,
on the box [-1, 1] and on 20 Lorentz-cone blocks.  Per lane, the port
must equal the JAX package in converged flag, matvec and iteration count.
x and the residual agree to 1e-10 on the box.  On the cone the two drift
apart faster: XLA rounds with fused multiply-adds, and the difference of
~1e-16 per step grows about tenfold every two iterations along an MPRGP
trajectory on the curved set (the JAX package's own fused/unfused test
allows for the same growth), so there they agree to 1e-8 (largest
difference measured: 8.3e-9, on the mixed segment set).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccqppy_tpu.models import MPRGPBBConfig as JaxMPRGPBBConfig
from ccqppy_tpu.models import MPRGPConfig as JaxMPRGPConfig
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import SOLVERS, mprgp, pcg
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)

B, N = 32, 60
ATOL = {"box": 1e-10, "cone": 1e-8}
JAX_CONFIG = {"mprgp": JaxMPRGPConfig, "mprgp_bb": JaxMPRGPBBConfig}


def family(seed, B=B, n=N):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    return A, -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (B, n)))


def jax_set(kind, n=N):
    if kind == "box":
        return JP.box(-np.ones(n), np.ones(n), dtype=jnp.float64)
    return JP.blockwise(JP.lorentz_cone(1.0, dtype=jnp.float64), 3)


def both(name, A, b, jproj, jcfg):
    rj = solve_batched(name, jnp.asarray(A), jnp.asarray(b), proj=jproj, config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = SOLVERS[name][0](At, bt, proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    return rj, rt


def assert_lanes_match(rj, rt, atol):
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=atol)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["box", "cone"])
@pytest.mark.parametrize("name", ["mprgp", "mprgp_bb"])
def test_fused_and_unfused_match_jax(name, kind):
    """Both forms match the JAX package per lane, and the port's fused form
    stands to its unfused form as the JAX package's do (same solutions,
    matvec totals within a few sweeps)."""
    A, b = family(1)
    runs = {}
    for fused in (True, False):
        jcfg = JAX_CONFIG[name](tol=1e-6, max_matvecs=2000, fused=fused, trace_len=8)
        rj, rt = both(name, A, b, jax_set(kind), jcfg)
        assert bool(np.asarray(rj.converged).all())
        assert_lanes_match(rj, rt, ATOL[kind])
        np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-5,
                                   atol=ATOL[kind])
        runs[fused] = rj, rt
    (jf, tf), (ju, tu) = runs[True], runs[False]
    np.testing.assert_array_equal((tf.matvecs - tu.matvecs).numpy(),
                                  np.asarray(jf.matvecs) - np.asarray(ju.matvecs))
    assert int((tf.matvecs - tu.matvecs).abs().max()) <= 6
    np.testing.assert_allclose(tf.x.numpy(), tu.x.numpy(), rtol=0, atol=5e-6)
    assert float(tf.residual.max()) < 1e-6


@pytest.mark.parametrize("fused", [True, False])
def test_fixed_expansion_matches_jax(fused):
    """The 2/||A||_inf expansion leg, on the box it is meant for; the
    scale of x_uncon makes many bounds bind, so expansions happen."""
    A, b = family(2, B=8)
    jcfg = JaxMPRGPBBConfig(tol=1e-8, max_matvecs=2000, fused=fused, expansion="fixed")
    rj, rt = both("mprgp_bb", A, 3 * b, jax_set("box"), jcfg)
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, ATOL["box"])


@pytest.mark.parametrize("kind", ["box", "cone"])
def test_budget_edge_matches_jax(kind):
    """Budgets that end lanes mid-trajectory, expansions included: the
    fused form returns the pre-expansion iterate with its residual, no
    budget exit reads as converged, and the unfused form may overrun the
    budget by the second matvec of an expansion, as the JAX package's does."""
    A, b = family(3, B=16)
    for budget in (7, 12, 19):
        for fused in (True, False):
            jcfg = JaxMPRGPBBConfig(tol=1e-10, max_matvecs=budget, fused=fused)
            rj, rt = both("mprgp_bb", A, b, jax_set(kind), jcfg)
            assert not bool(np.asarray(rj.converged).any())
            assert_lanes_match(rj, rt, ATOL[kind])


def test_warm_start_matches_jax():
    A, b = family(4, B=8)
    x0 = np.random.default_rng(5).uniform(-3, 3, (8, N))       # infeasible
    jproj = jax_set("cone")
    jcfg = JaxMPRGPBBConfig(tol=1e-6, max_matvecs=2000)
    rj = solve_batched("mprgp_bb", jnp.asarray(A), jnp.asarray(b), x0=jnp.asarray(x0),
                       proj=jproj, config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = mprgp.solve_bb(At, bt, x0=torch.from_numpy(x0), proj=proj_from_jax(jproj),
                        config=config_from_jax(jcfg))
    assert_lanes_match(rj, rt, ATOL["cone"])


def test_pcg_on_a_cone_is_mprgp_bb():
    """On a set that is not polyhedral the port's pcg delegates to fused
    MPRGP-BB, bit for bit, as the JAX package's does; and matches it."""
    A, b = family(5, B=8, n=9)
    jproj = jax_set("cone")
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    proj = proj_from_jax(jproj)
    r_pcg = pcg.solve(At, bt, proj=proj, config=pcg.PCGConfig(tol=1e-8, max_matvecs=2000))
    r_mb = mprgp.solve_bb(At, bt, proj=proj,
                          config=mprgp.MPRGPBBConfig(tol=1e-8, max_matvecs=2000))
    assert bool(r_pcg.converged.all())
    assert torch.equal(r_pcg.x, r_mb.x) and torch.equal(r_pcg.matvecs, r_mb.matvecs)
    jcfg = JaxPCGConfig(tol=1e-6, max_matvecs=2000)
    rj = solve_batched("pcg", jnp.asarray(A), jnp.asarray(b), proj=jproj, config=jcfg)
    rt = pcg.solve(At, bt, proj=proj, config=config_from_jax(jcfg))
    assert_lanes_match(rj, rt, ATOL["cone"])


def test_segment_set_matches_jax():
    """A mixed cone / box / identity segment composition under fused
    MPRGP-BB."""
    rng = np.random.default_rng(6)
    blocks = []
    for i in range(4):
        blocks.append((JP.lorentz_cone(float(rng.uniform(0.5, 1.5)), dtype=jnp.float64), 3))
        blocks.append((JP.box(rng.uniform(-2, 0, 2), rng.uniform(0.5, 2, 2),
                              dtype=jnp.float64), 2))
    blocks.append((JP.identity(), 2))
    jproj = JP.segment_product(*blocks)
    A, b = family(7, B=8, n=22)
    rj, rt = both("mprgp_bb", A, b, jproj, JaxMPRGPBBConfig(tol=1e-6, max_matvecs=2000))
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, ATOL["cone"])


def test_configs_carry_over_and_bad_expansion():
    for jcfg in (JaxMPRGPConfig(tol=2e-7, gamma=0.5, fused=False),
                 JaxMPRGPBBConfig(max_matvecs=99, expansion="fixed", trace_len=3)):
        cfg = config_from_jax(jcfg)
        assert type(cfg).__name__ == type(jcfg).__name__
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    A, b = family(0, B=1, n=6)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    with pytest.raises(ValueError, match="expansion"):
        mprgp.solve_bb(At, bt, config=mprgp.MPRGPBBConfig(expansion="fixd"))
