"""Port parity: ccqppy_tpu_torch's classic APGD and APGD-AR against
ccqppy_tpu's, f64, per lane.

The JAX side is ``solve_batched`` (vmap of the outer and the backtracking
while-loops, exact per lane); the port runs the backtracking as an inner
host loop in which only the lanes still backtracking take a trial.  Per lane
the port must equal the JAX package in ``converged``, matvec and iteration
count; x and the residual agree to 1e-10 on box families and 1e-8 on cone
families.

The tolerance is 1e-6: below ~1e-7 on these families both sides of the
Lipschitz test agree to rounding, with or without the default slack, and
its outcome then depends on the order of the sums, so the two packages can
part there (ROADMAP queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import APGDConfig as JaxAPGDConfig
from ccqppy_tpu.models import SOLVERS as JAX_SOLVERS
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import SOLVERS, apgd
from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)

B = 8
TOL = 1e-6
ATOL = {"box": 1e-10, "cone": 1e-8}
NAMES = ["apgd", "apgd_ar"]


def family(B, n, seed, scale=2.0):
    """A = G G^T + n I, b = -A x_uncon, x_uncon ~ U(-scale, scale); lane 0's
    unconstrained optimum is small."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    xu = rng.uniform(-scale, scale, (B, n))
    xu[0] = rng.uniform(-0.3, 0.3, n)
    return A, -np.einsum("bij,bj->bi", A, xu)


def jax_set(kind, n):
    if kind == "box":
        return cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64)
    return JP.blockwise(JP.lorentz_cone(1.0, dtype=jnp.float64), 3)


def both(name, A, b, jproj, jcfg, x0=None):
    rj = solve_batched(name, jnp.asarray(A), jnp.asarray(b),
                       x0=None if x0 is None else jnp.asarray(x0), proj=jproj, config=jcfg)
    rt = SOLVERS[name][0](torch.from_numpy(A), torch.from_numpy(b),
                          x0=None if x0 is None else torch.from_numpy(x0),
                          proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    return rj, rt


def assert_lanes_match(rj, rt, atol):
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=atol)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("slack", [16.0, 0.0], ids=["default_slack", "strict"])
@pytest.mark.parametrize("n", [24, 60])
@pytest.mark.parametrize("kind", ["box", "cone"])
@pytest.mark.parametrize("name", NAMES)
def test_apgd_matches_jax_per_lane(name, kind, n, slack):
    A, b = family(B, n, n)
    jcfg = JaxAPGDConfig(tol=TOL, max_matvecs=3000, backtrack_slack=slack, trace_len=10)
    rj, rt = both(name, A, b, jax_set(kind, n), jcfg)
    assert bool(np.asarray(rj.converged).all())
    assert len(set(np.asarray(rj.matvecs).tolist())) > 2        # lanes differ
    # Backtracking trials happened: more than the L0 sweep and two a step.
    trials = np.asarray(rj.matvecs) - 1 - 2 * np.asarray(rj.iterations)
    assert (trials >= 0).all() and trials.sum() > 0
    assert_lanes_match(rj, rt, ATOL[kind])
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-8,
                               atol=1e-14)


@pytest.mark.parametrize("kind", ["box", "cone"])
@pytest.mark.parametrize("name", NAMES)
def test_budget_ends_inside_an_iteration(name, kind):
    """An iteration spends ``A y``, then ``A x1``: from ``mv = max - 1`` it
    ends one matvec over the budget, in both packages."""
    n = 48
    A, b = family(B, n, 3, scale=3.0)
    over = 0
    for budget in (37, 38):
        rj, rt = both(name, A, b, jax_set(kind, n), JaxAPGDConfig(tol=1e-12, max_matvecs=budget))
        mv = np.asarray(rj.matvecs)
        assert not np.asarray(rj.converged).any()
        assert set(mv.tolist()) <= {budget, budget + 1}
        over += int((mv > budget).sum())
        assert_lanes_match(rj, rt, ATOL[kind])
    assert over > 0


@pytest.mark.parametrize("name", NAMES)
def test_max_backtracks_reached_from_the_guarded_start(name):
    """From x0 = 1 the L0 estimate divides by ||x0 - 1|| = 0 and is guarded
    to 1, far below lambda_min(A) >= n: the first iterations spend their
    three allowed trials and go on with a bound that does not hold.  The
    cap changes the lanes' counts, alike in both packages."""
    n = 48
    A, b = family(B, n, 9)
    x0 = np.ones((B, n))
    jproj = jax_set("box", n)
    capped, free = (JaxAPGDConfig(tol=TOL, max_matvecs=3000, max_backtracks=k) for k in (3, 64))
    rj, rt = both(name, A, b, jproj, capped, x0)
    rj_free, rt_free = both(name, A, b, jproj, free, x0)
    assert bool(np.asarray(rj.converged).all())
    assert (np.asarray(rj.matvecs) != np.asarray(rj_free.matvecs)).sum() > B // 2
    assert_lanes_match(rj, rt, ATOL["box"])
    assert_lanes_match(rj_free, rt_free, ATOL["box"])


@pytest.mark.parametrize("kind", ["box", "cone"])
def test_anti_relaxation_returns_best_iterate_with_last_residual(kind):
    """On a budget-exhausted lane APGD-AR returns its best iterate xhat,
    whose residual is the least of the history, beside the LAST iterate's
    residual, as the JAX package does."""
    n = 48
    A, b = family(B, n, 7, scale=3.0)
    jproj = jax_set(kind, n)
    jcfg = JaxAPGDConfig(tol=1e-12, max_matvecs=45, trace_len=45)
    rj, rt = both("apgd_ar", A, b, jproj, jcfg)
    assert not np.asarray(rj.converged).any()
    assert_lanes_match(rj, rt, ATOL[kind])
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    res_x = pg_residual(proj_from_jax(jproj), rt.x, torch.einsum("bij,bj->bi", At, rt.x) + bt,
                        jcfg.gd).numpy()
    best = np.nanmin(rt.trace.numpy(), axis=1)
    np.testing.assert_allclose(res_x, best, rtol=1e-9)
    differ = rt.residual.numpy() > res_x * (1 + 1e-6)
    assert differ.sum() >= 4             # xhat is not the last iterate there
    # Classic APGD reports its last iterate with that iterate's residual.
    rc = apgd.solve(At, bt, proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    res_c = pg_residual(proj_from_jax(jproj), rc.x, torch.einsum("bij,bj->bi", At, rc.x) + bt,
                        jcfg.gd)
    np.testing.assert_allclose(res_c.numpy(), rc.residual.numpy(), rtol=1e-9)


def test_solve_anti_relaxation_sets_the_flag():
    n = 24
    At, bt = problem_from_numpy(*family(4, n, 6), "cpu", torch.float64)
    proj = proj_from_jax(jax_set("box", n))
    cfg = apgd.APGDConfig(tol=TOL, max_matvecs=500)
    r = apgd.solve_anti_relaxation(At, bt, proj=proj, config=cfg)
    r_flag = apgd.solve(At, bt, proj=proj, config=dataclasses.replace(cfg, anti_relaxation=True))
    r_default = apgd.solve_anti_relaxation(At, bt, proj=proj)
    assert torch.equal(r.x, r_flag.x) and torch.equal(r.matvecs, r_flag.matvecs)
    assert bool(r_default.converged.all())
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        apgd.solve(At, bt[0])


def test_solvers_registry_matches_jax():
    assert list(SOLVERS) == list(JAX_SOLVERS)
    assert SOLVERS["apgd"] == (apgd.solve, apgd.APGDConfig)
    assert SOLVERS["apgd_ar"] == (apgd.solve_anti_relaxation, apgd.APGDConfig)
    for name, (_, jcls) in JAX_SOLVERS.items():
        assert SOLVERS[name][1].__name__ == jcls.__name__
        assert ({f.name for f in dataclasses.fields(SOLVERS[name][1])}
                == {f.name for f in dataclasses.fields(jcls)})


def test_config_carries_over_field_for_field():
    jcfg = JaxAPGDConfig(tol=3e-7, max_matvecs=77, backtrack_grow=3.0, relax=0.8,
                         max_backtracks=9, anti_relaxation=True, backtrack_slack=4.0,
                         trace_len=5)
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, apgd.APGDConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_apgd_f32_residual_band_matches_jax():
    """In f32 classic APGD's residual does not settle: past the first
    hundred iterations it bounces in a band around 3e-4 (n=256, box [-1, 1],
    the Wishart family from the Jacobi start), in both packages alike.  The
    Lipschitz test's slack, 16 eps (|lhs| + |rhs|), outweighs the bound's
    violation there, so L relaxes by 0.9 an iteration below the curvature
    until a step overshoots far enough to fail the test.  A lane exits only
    when a dip of the band crosses tol: at tol 2e-5 a few percent of the
    iterations, at 1e-4 about a quarter.  In f64 the same lanes descend
    through 2e-5 and stay below it."""
    n, B = 256, 4
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (B, n)))
    for dtype in (np.float32, np.float64):
        A_, b_ = A.astype(dtype), b.astype(dtype)
        x0 = np.clip(-b_ / np.einsum("bii->bi", A_), -1, 1)
        jproj = cq.box(-np.ones(n, dtype), np.ones(n, dtype), dtype=jnp.dtype(dtype))
        jcfg = JaxAPGDConfig(tol=1e-13, max_matvecs=1200, trace_len=500)
        rj, rt = both("apgd", A_, b_, jproj, jcfg, x0)
        for r in (rj, rt):
            late = np.asarray(r.trace)[:, 100:]
            if dtype is np.float32:
                median = np.median(late, axis=1)
                assert ((2e-4 < median) & (median < 6e-4)).all(), median
                assert (np.mean(late < 2e-5, axis=1) < 0.12).all()
                assert (np.mean(late < 1e-4, axis=1) > 0.15).all()
            else:
                assert (late[np.isfinite(late)] < 2e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_apgd_on_cuda_matches_cpu(name):
    """APGD and APGD-AR on a small cone batch on the card, in f32 through
    the GEMV kernel, against the same solve on the CPU in f64: every lane
    converged, solutions within 6 tol, each matvec a GEMV launch.  Classic
    APGD runs at tol 1e-4: in f32 its residual bounces in a band above 1e-5
    (``test_apgd_f32_residual_band_matches_jax``), and at 1e-5 one lane of
    these eight spent the budget on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccqppy_tpu_torch.ops import gemv

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n, tol = 99, {"apgd": 1e-4, "apgd_ar": 1e-5}[name]
    A, b = problem_from_numpy(*family(8, n, 7, scale=1.0), "cpu", torch.float64)
    cfg = apgd.APGDConfig(tol=tol, max_matvecs=2000)
    r64 = SOLVERS[name][0](A, b, proj=proj_from_jax(jax_set("cone", n)), config=cfg)
    before = gemv.LAUNCHES
    r32 = SOLVERS[name][0](A.float().to(dev), b.float().to(dev),
                           proj=proj_from_jax(jax_set("cone", n)).to(dev).float(), config=cfg)
    torch.cuda.synchronize()
    assert gemv.LAUNCHES - before >= int(r32.matvecs.max())
    assert bool(r32.converged.all()) and bool(r64.converged.all())
    np.testing.assert_allclose(r32.x.cpu().numpy(), r64.x.numpy(), rtol=0, atol=6 * tol)
