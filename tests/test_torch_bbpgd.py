"""Port parity: ccqppy_tpu_torch's pgd, bbpgd and bbpgd_f against
ccqppy_tpu's, f64.

The JAX side is ``solve_batched`` (vmap of the while-loop, exact per lane);
the port runs the same batch with explicit lane masks.  Lane 0's optimum is
interior; the other lanes have many active bounds and need different
numbers of iterations.  Per lane the port must equal the JAX package in
``converged``, matvec and iteration count, and x and the residual must
agree to 1e-10.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import BBPGDConfig as JaxBBPGDConfig
from ccqppy_tpu.models import BBPGDfConfig as JaxBBPGDfConfig
from ccqppy_tpu.models import PGDConfig as JaxPGDConfig
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import SOLVERS, bbpgd, pgd
from ccqppy_tpu_torch.models.base import SolverConfig
from ccqppy_tpu_torch.parallel import solve_batched as port_solve_batched
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)

JAX_CONFIG = {"pgd": JaxPGDConfig, "bbpgd": JaxBBPGDConfig, "bbpgd_f": JaxBBPGDfConfig}
BB = ["bbpgd", "bbpgd_f"]


def family(B, n, seed, scale=3.0, spread=0.0):
    """A = D (G G^T + n I) D with D = exp(spread * N(0, 1)) (a heterogeneous
    diagonal for spread > 0), b = -A x_uncon, x_uncon ~ U(-scale, scale);
    lane 0's optimum is interior to [-1, 1]."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    d = np.exp(spread * rng.standard_normal((B, n)))
    A = d[:, :, None] * A * d[:, None, :]
    xu = rng.uniform(-scale, scale, (B, n))
    xu[0] = rng.uniform(-0.5, 0.5, n)
    return A, -np.einsum("bij,bj->bi", A, xu)


def jax_set(kind, n):
    return {"box": cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64),
            "lower": cq.lower_bound(-np.ones(n), dtype=jnp.float64),
            "upper": cq.upper_bound(np.ones(n), dtype=jnp.float64),
            "identity": cq.identity()}[kind]


def both(name, A, b, jproj, jcfg, x0=None):
    rj = solve_batched(name, jnp.asarray(A), jnp.asarray(b),
                       x0=None if x0 is None else jnp.asarray(x0), proj=jproj, config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = SOLVERS[name][0](At, bt, x0=None if x0 is None else torch.from_numpy(x0),
                          proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    return rj, rt


def assert_lanes_match(rj, rt, restol=1e-12):
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=1e-9, atol=restol)


@pytest.mark.parametrize("kind", ["box", "identity"])
def test_pgd_matches_jax_per_lane(kind):
    n = 40
    A, b = family(6, n, seed=1)
    # lambda_max(A) <= ~5n = 200: the step 1/(2.5 n) is stable.
    jcfg = JaxPGDConfig(tol=1e-8, max_matvecs=3000, step_size=1 / (2.5 * n), trace_len=6)
    rj, rt = both("pgd", A, b, jax_set(kind, n), jcfg)
    assert bool(np.asarray(rj.converged).all())
    assert len(set(np.asarray(rj.matvecs).tolist())) > 2     # lanes differ
    assert_lanes_match(rj, rt)
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-9)


@pytest.mark.parametrize("kind", ["box", "lower", "upper"])
@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("name", BB)
def test_bb_matches_jax_per_lane(name, precond, kind):
    n = 48
    A, b = family(8, n, seed=2, spread=0.2)
    jcfg = JAX_CONFIG[name](tol=1e-8, max_matvecs=3000, precond=precond)
    rj, rt = both(name, A, b, jax_set(kind, n), jcfg)
    assert bool(np.asarray(rj.converged).all())
    assert len(set(np.asarray(rj.matvecs).tolist())) > 2
    assert_lanes_match(rj, rt)


def test_jacobi_metric_pays_on_a_heterogeneous_diagonal():
    """With diag(A) spread (D = exp(0.3 N(0, 1))) the Jacobi metric needs
    about half the matvecs, in both packages alike."""
    n = 48
    A, b = family(8, n, seed=2, spread=0.3)
    counts = {}
    for precond in ("none", "jacobi"):
        jcfg = JaxBBPGDfConfig(tol=1e-8, max_matvecs=5000, precond=precond)
        rj, rt = both("bbpgd_f", A, b, jax_set("box", n), jcfg)
        assert_lanes_match(rj, rt)
        counts[precond] = int(rt.matvecs.sum())
    assert counts["jacobi"] < counts["none"]


@pytest.mark.parametrize("budget", [2, 3, 12])
@pytest.mark.parametrize("name", BB)
def test_bb_budget_matches_jax(name, budget):
    """The two init matvecs (gradient and initial alpha) count: at a budget
    of 2 or 3 a lane stops after one iteration at 3 matvecs, as in the JAX
    package; at 12 every lane exhausts it."""
    n = 40
    A, b = family(6, n, seed=4)
    jcfg = JAX_CONFIG[name](tol=1e-10, max_matvecs=budget)
    rj, rt = both(name, A, b, jax_set("box", n), jcfg)
    assert not bool(np.asarray(rj.converged).any())
    np.testing.assert_array_equal(rt.matvecs.numpy(), max(budget, 3))
    assert_lanes_match(rj, rt)


def test_bb_warm_start_and_trace_match_jax():
    n = 48
    A, b = family(8, n, seed=5)
    x0 = np.random.default_rng(6).uniform(-2, 2, (8, n))    # infeasible: projected
    jcfg = JaxBBPGDfConfig(tol=1e-8, max_matvecs=3000, trace_len=12)
    rj, rt = both("bbpgd_f", A, b, jax_set("box", n), jcfg, x0)
    assert_lanes_match(rj, rt)
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-9,
                               atol=1e-14)


def test_bbpgd_f_stagnation_restart_matches_jax():
    """The Hessians scaled by 1e16 make every BB step alpha ~ 1e-16, below
    10 eps = 2.2e-15, so BBPGDf restarts from proj(xmin - gd gmin) with the
    stale gradient (gd = 1e-16 is a stable step at this scale).  The restart
    fires in the JAX run: its residual histories leave BBPGD's.  The
    residual divides by gd, so the sums' order shows in it at ~1e-9 relative;
    x agrees to 1e-10."""
    B, n, S = 6, 32, 1e16
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, n, n))
    A = (G @ G.transpose(0, 2, 1) + n * np.eye(n)) / (5 * n) * S
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-3, 3, (B, n)))
    jproj = jax_set("box", n)
    kw = dict(tol=1e7, max_matvecs=400, gd=1e-16, trace_len=40)
    r_plain = solve_batched("bbpgd", jnp.asarray(A), jnp.asarray(b), proj=jproj,
                            config=JaxBBPGDConfig(**kw))
    rj, rt = both("bbpgd_f", A, b, jproj, JaxBBPGDfConfig(**kw))
    assert bool(np.asarray(rj.converged).all())
    differ = ~np.isclose(np.asarray(r_plain.trace), np.asarray(rj.trace), equal_nan=True)
    assert differ.any(axis=1).all()                  # the restart fired on every lane
    assert_lanes_match(rj, rt, restol=1e-9 * np.asarray(rj.residual).max())


def test_solvers_and_configs_are_registered():
    assert SOLVERS["pgd"] == (pgd.solve, pgd.PGDConfig)
    assert SOLVERS["bbpgd"] == (bbpgd.solve, bbpgd.BBPGDConfig)
    assert SOLVERS["bbpgd_f"] == (bbpgd.solve_fallback, bbpgd.BBPGDfConfig)
    assert pgd.PGDConfig().step_size == 0.01
    with pytest.raises(ValueError, match="precond"):
        bbpgd.solve(torch.eye(2)[None], torch.ones(1, 2),
                    config=bbpgd.BBPGDConfig(precond="diag"))


@pytest.mark.parametrize("jcfg", [
    JaxPGDConfig(tol=3e-7, max_matvecs=77, step_size=0.2, trace_len=4),
    JaxBBPGDConfig(tol=1e-5, max_matvecs=9, precond="jacobi", gd=1e-7),
    JaxBBPGDfConfig(tol=2e-5, max_matvecs=500)], ids=["pgd", "bbpgd", "bbpgd_f"])
def test_config_carries_over_field_for_field(jcfg):
    cfg = config_from_jax(jcfg)
    assert type(cfg).__name__ == type(jcfg).__name__ and isinstance(cfg, SolverConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_readme_quick_start_through_solve_batched():
    """``solve_batched("bbpgd_f", ...)``, the README's batched quick start,
    on the port: the same result as the solver called directly."""
    n = 32
    A, b = family(4, n, seed=7)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    proj = proj_from_jax(jax_set("box", n))
    cfg = bbpgd.BBPGDfConfig(tol=1e-8, max_matvecs=2000)
    r = port_solve_batched("bbpgd_f", At, bt, proj=proj, config=cfg)
    r2 = bbpgd.solve_fallback(At, bt, proj=proj, config=cfg)
    assert bool(r.converged.all()) and torch.equal(r.x, r2.x)


def test_bbpgd_f_f32_stall_matches_jax():
    """In f32 the BB denominator's guard 10 eps = 1.2e-6 outweighs dx.dg
    once a lane is near its optimum; alpha then drops below 10 eps, the
    restart step gd gmin is below f32 resolution, and the lane freezes above
    tol until the budget ends.  At n=256, tol 2e-5 this takes lane 6 of this
    batch in both packages alike (not at n=1000, the main path's width)."""
    n = 256
    A, b = family(16, n, seed=8, scale=0.8)
    jproj = cq.box(-np.ones(n, np.float32), np.ones(n, np.float32), dtype=jnp.float32)
    jcfg = JaxBBPGDfConfig(tol=2e-5, max_matvecs=500)
    A32, b32 = A.astype(np.float32), b.astype(np.float32)
    rj = solve_batched("bbpgd_f", jnp.asarray(A32), jnp.asarray(b32), proj=jproj, config=jcfg)
    rt = bbpgd.solve_fallback(torch.from_numpy(A32), torch.from_numpy(b32),
                              proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    np.testing.assert_array_equal(np.flatnonzero(~np.asarray(rj.converged)), [6])
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    # f32 sums in another order: x agrees to ~1.5e-6 (a few f32 ulps of 1).
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_bbpgd_f_on_cuda_matches_cpu_f64():
    """bbpgd_f on the card in f32 (through the f32 kernel) against the port
    on the CPU in f64: every lane converged, solutions within 6 tol.  The
    tol sits above the f32 stall of ``test_bbpgd_f_f32_stall_matches_jax``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccqppy_tpu_torch.ops import gemv

    dev = torch.device("cuda", 0)
    n, tol = 256, 1e-4
    A, b = family(16, n, seed=8, scale=0.8)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    proj = proj_from_jax(jax_set("box", n))
    cfg = bbpgd.BBPGDfConfig(tol=tol, max_matvecs=500)
    r64 = bbpgd.solve_fallback(At, bt, proj=proj, config=cfg)
    before = gemv.LAUNCHES
    r32 = bbpgd.solve_fallback(At.float().to(dev), bt.float().to(dev),
                               proj=proj_from_jax(jax_set("box", n)).to(dev).float(),
                               config=cfg)
    assert gemv.LAUNCHES - before >= int(r32.matvecs.max())
    assert bool(r32.converged.all()) and bool(r64.converged.all())
    np.testing.assert_allclose(r32.x.cpu().numpy(), r64.x.numpy(), rtol=0, atol=6 * tol)
