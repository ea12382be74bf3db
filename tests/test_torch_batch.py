"""Port parity: ccqppy_tpu_torch.parallel.batch against ccqppy_tpu's, f64.

The phase-1 budget and the bucket are small enough that the stragglers
overflow the bucket, so both the overflow semantics (honest phase-1 state)
and the host fallback are exercised.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.parallel.batch import solve_batched as jax_solve_batched
from ccqppy_tpu.parallel.batch import \
    solve_batched_fused_compact as jax_fused_compact
from ccqppy_tpu_torch.ops.linop import DenseOperator, SymmetricPackedDense
from ccqppy_tpu_torch.parallel import batch
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)

B, N = 32, 96
PHASE1, BUCKET = 12, 4


def _problem(seed=21):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, N, N))
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    xu = rng.uniform(-2.0, 2.0, (B, N))
    return A, -np.einsum("bij,bj->bi", A, xu)


def _assert_lanes_match(rj, rt):
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("host_fallback", [False, True])
def test_fused_compact_matches_jax(host_fallback):
    A, b = _problem()
    jproj = cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=300)
    rj = jax_fused_compact("pcg", jnp.asarray(A), jnp.asarray(b), PHASE1,
                           proj=jproj, config=jcfg, bucket=BUCKET,
                           host_fallback=host_fallback)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = batch.solve_batched_fused_compact(
        "pcg", At, bt, PHASE1, proj=proj_from_jax(jproj),
        config=config_from_jax(jcfg), bucket=BUCKET, host_fallback=host_fallback)
    conv = np.asarray(rj.converged)
    if host_fallback:
        assert conv.all()
    else:
        # More than BUCKET stragglers: the overflow keeps its phase-1 state.
        assert BUCKET < (~conv).sum() and (np.asarray(rj.matvecs)[~conv] == PHASE1).all()
    _assert_lanes_match(rj, rt)


def test_solve_batched_matches_jax():
    A, b = _problem(22)
    A, b = A[:6], b[:6]
    jproj = cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=300, precond="jacobi")
    rj = jax_solve_batched("pcg", jnp.asarray(A), jnp.asarray(b), proj=jproj,
                           config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = batch.solve_batched("pcg", At, bt, proj=proj_from_jax(jproj),
                             config=config_from_jax(jcfg))
    _assert_lanes_match(rj, rt)


def test_host_compact_finish_only_touches_eligible_lanes():
    A, b = _problem(23)
    At, bt = problem_from_numpy(A[:8], b[:8], "cpu", torch.float64)
    proj = proj_from_jax(cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64))
    cfg1 = batch.SOLVERS["pcg"][1](tol=1e-8, max_matvecs=6)
    cfg2 = batch.SOLVERS["pcg"][1](tol=1e-8, max_matvecs=300)
    r1 = batch.solve_batched("pcg", At, bt, proj=proj, config=cfg1)
    eligible = torch.zeros(8, dtype=torch.bool)
    eligible[[1, 5]] = True
    r = batch.host_compact_finish(
        lambda A2, b2, x02, p2, k2: batch.solve_batched("pcg", A2, b2, x02, p2, cfg2),
        At, bt, r1, proj, eligible=eligible)
    assert r.converged[[1, 5]].all()
    keep = ~eligible
    np.testing.assert_array_equal(r.x[keep].numpy(), r1.x[keep].numpy())
    np.testing.assert_array_equal(r.matvecs[keep].numpy(), r1.matvecs[keep].numpy())
    assert (r.matvecs[eligible] > r1.matvecs[eligible]).all()


def test_rejects_what_is_not_ported_or_invalid():
    A, b = _problem(24)
    At, bt = problem_from_numpy(A[:2], b[:2], "cpu", torch.float64)
    cfg = batch.SOLVERS["pcg"][1](tol=1e-8, max_matvecs=20)
    # Keys are (B,) int64 per-lane seeds: a float tensor or a wrong length
    # is refused by every batch entry point before any solve.
    for keys, error in ((torch.zeros(2), TypeError),
                        (torch.zeros(3, dtype=torch.int64), ValueError)):
        with pytest.raises(error):
            batch.solve_batched("pcg", At, bt, config=cfg, keys=keys)
        with pytest.raises(error):
            batch.solve_batched_compact("spg", At, bt, 5, config=cfg, keys=keys)
        with pytest.raises(error):
            batch.solve_batched_fused_compact("spg", At, bt, 5, config=cfg, keys=keys)
    with pytest.raises(ValueError):
        batch.solve_batched_fused_compact("pcg", At, bt, 18, config=cfg)
    with pytest.raises(ValueError, match="< 4 matvecs"):
        batch.solve_batched_compact("pcg", At, bt, 17, config=cfg)
    with pytest.raises(TypeError):
        batch.solve_batched_fused_compact(batch.SOLVERS["pcg"][0], At, bt, 5,
                                          config=cfg)


@pytest.mark.parametrize("bucket", [BUCKET, B])
def test_proj_batched_compaction(bucket):
    """Per-lane box bounds (a leading lane axis on lb and ub) through fused
    compaction: the stragglers' bounds are gathered with them, in the bucket
    and in the host fallback.  Per lane this is the JAX package's two-phase
    compaction with proj_batched=True."""
    from ccqppy_tpu.parallel.batch import solve_batched_compact as jax_compact

    A, b = _problem(26)
    rng = np.random.default_rng(27)
    lb, ub = -rng.uniform(0.5, 2.0, (B, N)), rng.uniform(0.5, 2.0, (B, N))
    jproj = cq.box(lb, ub, dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=300)
    rj = jax_compact("pcg", jnp.asarray(A), jnp.asarray(b), PHASE1, proj=jproj,
                     config=jcfg, proj_batched=True)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    proj = proj_from_jax(jproj)
    assert proj.lb.shape == (B, N)
    rt = batch.solve_batched_fused_compact("pcg", At, bt, PHASE1, proj=proj,
                                           config=config_from_jax(jcfg), bucket=bucket,
                                           proj_batched=True)
    assert bool(np.asarray(rj.converged).all())
    assert BUCKET < int((np.asarray(rj.matvecs) > PHASE1).sum())   # overflow at BUCKET
    _assert_lanes_match(rj, rt)
    # Shared bounds where per-lane ones are promised are refused.
    with pytest.raises(ValueError, match="lane axis"):
        batch.solve_batched("pcg", At, bt, proj=proj_from_jax(cq.box(-np.ones(N), np.ones(N))),
                            config=config_from_jax(jcfg), proj_batched=True)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_compaction_takes_operators(kind):
    """Both compaction entry points gather the lanes of an operator as they
    do of a raw stack, and match the raw-stack run per lane.  The dense
    operator runs the same GEMV, so it matches bitwise; the packed one
    (N=96 at tile 32: 6 upper tiles) sums in another order, so x agrees to
    1e-10 and the per-lane counts exactly."""
    A, b = _problem(25)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    op = DenseOperator(At) if kind == "dense" else SymmetricPackedDense.from_dense(At, tile=32)
    proj = proj_from_jax(cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64))
    cfg = batch.SOLVERS["pcg"][1](tol=1e-8, max_matvecs=300)
    tol = 0 if kind == "dense" else 1e-10

    def assert_same(r_raw, r_op):
        np.testing.assert_array_equal(r_op.converged.numpy(), r_raw.converged.numpy())
        np.testing.assert_array_equal(r_op.matvecs.numpy(), r_raw.matvecs.numpy())
        np.testing.assert_array_equal(r_op.iterations.numpy(), r_raw.iterations.numpy())
        np.testing.assert_allclose(r_op.x.numpy(), r_raw.x.numpy(), rtol=0, atol=tol)

    for fallback in (False, True):
        runs = [batch.solve_batched_fused_compact("pcg", a, bt, PHASE1, proj=proj, config=cfg,
                                                  bucket=BUCKET, host_fallback=fallback)
                for a in (At, op)]
        assert BUCKET < int((~runs[0].converged).sum()) or fallback
        assert_same(*runs)

    cfg1 = batch.SOLVERS["pcg"][1](tol=1e-8, max_matvecs=PHASE1)
    runs = []
    for a in (At, op):
        r1 = batch.solve_batched("pcg", a, bt, proj=proj, config=cfg1)
        runs.append(batch.host_compact_finish(
            lambda A2, b2, x02, p2, k2: batch.solve_batched("pcg", A2, b2, x02, p2, cfg),
            a, bt, r1, proj))
    assert bool(runs[0].converged.all())
    assert_same(*runs)


@pytest.mark.parametrize("name", ["pcg", "bbpgd"])
def test_solve_batched_compact_matches_jax(name):
    """``solve_batched_compact``: phase 1 on a budget that leaves stragglers,
    then the stragglers warm-started on what it left; per lane as the JAX
    package's function of the same name."""
    from ccqppy_tpu.models import BBPGDConfig as JaxBBPGDConfig
    from ccqppy_tpu.parallel.batch import solve_batched_compact as jax_compact

    A, b = _problem(28)
    jproj = cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = {"pcg": JaxPCGConfig, "bbpgd": JaxBBPGDConfig}[name](tol=1e-8, max_matvecs=300)
    rj = jax_compact(name, jnp.asarray(A), jnp.asarray(b), PHASE1, proj=jproj, config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = batch.solve_batched_compact(name, At, bt, PHASE1, proj=proj_from_jax(jproj),
                                     config=config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    assert int((np.asarray(rj.matvecs) > PHASE1).sum()) > BUCKET        # stragglers
    _assert_lanes_match(rj, rt)
    with pytest.raises(ValueError, match="< 4 matvecs"):
        jax_compact(name, jnp.asarray(A), jnp.asarray(b), 297, proj=jproj, config=jcfg)
    with pytest.raises(ValueError, match="< 4 matvecs"):
        batch.solve_batched_compact(name, At, bt, 297, proj=proj_from_jax(jproj),
                                    config=config_from_jax(jcfg))
