"""Port parity: ccqppy_tpu_torch's SPG and per-lane keys against
ccqppy_tpu's, f64, per lane; and the port's counter-based RNG.

The JAX package draws SPG's step from threefry (``split`` then ``uniform``
per iteration), which torch cannot reproduce, so the JAX uniforms of each
lane are precomputed here and fed to the port through ``spg.solve``'s
``draw`` hook, keyed by the port's lane keys.  The hook follows a lane's
key, so it follows the lane through compaction and ``fold_in``.  Per lane
the port must equal the JAX package in ``converged``, matvec and iteration
count; x and the residual agree to 1e-10 on box families and 1e-8 on cone
families (XLA's fused multiply-adds, ROADMAP queue 3).
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import SPGConfig as JaxSPGConfig
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel import batch as jbatch
from ccqppy_tpu_torch.models import SOLVERS, spg
from ccqppy_tpu_torch.parallel import batch
from ccqppy_tpu_torch.utils import rng
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)

B = 8
ATOL = {"box": 1e-10, "cone": 1e-8}


def family(B, n, seed, scale=2.0):
    """A = G G^T + n I, b = -A x_uncon, x_uncon ~ U(-scale, scale); lane 0's
    unconstrained optimum is small."""
    rng_ = np.random.default_rng(seed)
    G = rng_.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    xu = rng_.uniform(-scale, scale, (B, n))
    xu[0] = rng_.uniform(-0.3, 0.3, n)
    return A, -np.einsum("bij,bj->bi", A, xu)


def jax_set(kind, n):
    if kind == "box":
        return cq.box(-np.ones(n), np.ones(n), dtype=jnp.float64)
    return JP.blockwise(JP.lorentz_cone(1.0, dtype=jnp.float64), 3)


def jax_uniforms(jkeys, T):
    """Per lane, the uniforms the JAX package's SPG draws at iterations
    0..T-1: ``key, sub = split(key)`` then ``uniform(sub)``."""
    def stream(k):
        def step(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, dtype=jnp.float64)
        return jax.lax.scan(step, k, None, length=T)[1]
    return np.asarray(jax.vmap(stream)(jkeys))


def draw_table(pairs, T):
    """A ``draw(keys, it)`` hook: each port key of ``pairs`` (port keys, JAX
    keys) draws the JAX stream of its JAX key."""
    pkeys = torch.cat([p for p, _ in pairs])
    U = torch.from_numpy(np.concatenate([jax_uniforms(j, T) for _, j in pairs]))
    order = torch.argsort(pkeys)
    sorted_keys = pkeys[order]

    def draw(keys, it):
        pos = torch.searchsorted(sorted_keys, keys).clamp(max=len(sorted_keys) - 1)
        assert torch.equal(sorted_keys[pos], keys), "a key the table does not hold"
        return U[order[pos], it.long()]
    return draw


def lane_keys(seed, B=B):
    """The port's keys and the JAX package's for the same seed."""
    return rng.split_keys(seed, B), jax.random.split(jax.random.PRNGKey(seed), B)


def assert_lanes_match(rj, rt, atol):
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=atol)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=atol)


def both(A, b, jproj, jcfg, seed, x0=None, T=3000):
    """The JAX package's batched SPG with keys from ``seed`` and the port's
    with the JAX uniforms through ``draw``."""
    pk, jk = lane_keys(seed)
    rj = jbatch.solve_batched("spg", jnp.asarray(A), jnp.asarray(b),
                              x0=None if x0 is None else jnp.asarray(x0), proj=jproj,
                              config=jcfg, keys=jk)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = spg.solve(At, bt, x0=None if x0 is None else torch.from_numpy(x0),
                   proj=proj_from_jax(jproj), config=config_from_jax(jcfg), keys=pk,
                   draw=draw_table([(pk, jk)], T))
    return rj, rt


@pytest.mark.parametrize("criterion", ["eq25", "d_norm"])
@pytest.mark.parametrize("kind", ["box", "cone"])
def test_spg_matches_jax_per_lane(kind, criterion):
    """Every lane runs past the m=5 ring, so the GLL max reads a wrapped
    ring; the lanes need different iteration counts."""
    n = 48
    A, b = family(B, n, 1)
    jcfg = JaxSPGConfig(tol=1e-8, max_matvecs=3000, criterion=criterion, trace_len=8)
    rj, rt = both(A, b, jax_set(kind, n), jcfg, seed=3)
    assert bool(np.asarray(rj.converged).all())
    assert int(np.asarray(rj.iterations).min()) > 2 * 5
    assert len(set(np.asarray(rj.matvecs).tolist())) > 2
    assert_lanes_match(rj, rt, ATOL[kind])
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-8,
                               atol=1e-14)


@pytest.mark.parametrize("budget", [2, 3, 17])
@pytest.mark.parametrize("kind", ["box", "cone"])
def test_spg_budget_matches_jax(kind, budget):
    """The two init matvecs count; a lane stops after one iteration at 3
    matvecs under a budget of 2 or 3, and every lane exhausts 17."""
    n = 36
    A, b = family(B, n, 2, scale=3.0)
    rj, rt = both(A, b, jax_set(kind, n), JaxSPGConfig(tol=1e-10, max_matvecs=budget), 4)
    assert not bool(np.asarray(rj.converged).any())
    np.testing.assert_array_equal(rt.matvecs.numpy(), max(budget, 3))
    assert_lanes_match(rj, rt, ATOL[kind])


def test_spg_warm_start_and_ring_of_three_match_jax():
    """An infeasible x0 is projected; a ring of m=3 and other step bounds
    carry over."""
    n = 30
    A, b = family(B, n, 5)
    x0 = np.random.default_rng(6).uniform(-2, 2, (B, n))
    jcfg = JaxSPGConfig(tol=1e-9, max_matvecs=3000, m=3, tau=0.3, sigma1=0.05, sigma2=0.9)
    rj, rt = both(A, b, jax_set("box", n), jcfg, seed=7, x0=x0)
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, ATOL["box"])


def test_spg_keys_through_solve_batched():
    n = 33
    A, b = family(B, n, 8)
    jproj = jax_set("cone", n)
    jcfg = JaxSPGConfig(tol=1e-8, max_matvecs=3000)
    pk, jk = lane_keys(9)
    rj = jbatch.solve_batched("spg", jnp.asarray(A), jnp.asarray(b), proj=jproj,
                              config=jcfg, keys=jk)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = batch.solve_batched(partial(spg.solve, draw=draw_table([(pk, jk)], 3000)), At, bt,
                             proj=proj_from_jax(jproj), config=config_from_jax(jcfg), keys=pk)
    assert_lanes_match(rj, rt, ATOL["cone"])


@pytest.mark.parametrize("phase1", [12, 30])
def test_spg_compact_restarts_phase_two_on_the_same_keys(phase1):
    """``solve_batched_compact``: the stragglers restart their own streams
    from iteration 0 on the same keys, as the JAX package's does."""
    n = 48
    A, b = family(B, n, 10)
    jproj = jax_set("box", n)
    jcfg = JaxSPGConfig(tol=1e-8, max_matvecs=3000)
    pk, jk = lane_keys(11)
    rj = jbatch.solve_batched_compact("spg", jnp.asarray(A), jnp.asarray(b), phase1,
                                      proj=jproj, config=jcfg, keys=jk)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = batch.solve_batched_compact(partial(spg.solve, draw=draw_table([(pk, jk)], 3000)),
                                     At, bt, phase1, proj=proj_from_jax(jproj),
                                     config=config_from_jax(jcfg), keys=pk)
    assert bool(np.asarray(rj.converged).all())
    assert int((np.asarray(rj.matvecs) > phase1).sum()) > 1           # stragglers
    assert_lanes_match(rj, rt, ATOL["box"])


@pytest.mark.parametrize("host_fallback", [False, True])
def test_spg_fused_compact_folds_phase_two_keys(host_fallback, monkeypatch):
    """``solve_batched_fused_compact`` with more stragglers than the bucket:
    phase 2 runs on ``fold_in(keys, 1)`` in the bucket and in the host
    fallback.  The hook maps the port's folded keys to the JAX package's
    ``fold_in(key, 1)`` streams."""
    n = 48
    phase1, bucket = 60, 2
    A, b = family(B, n, 12)
    jproj = jax_set("cone", n)
    jcfg = JaxSPGConfig(tol=1e-8, max_matvecs=3000)
    pk, jk = lane_keys(13)
    jk1 = jax.vmap(lambda k: jax.random.fold_in(k, 1))(jk)
    draw = draw_table([(pk, jk), (rng.fold_in(pk, 1), jk1)], 3000)
    monkeypatch.setitem(batch.SOLVERS, "spg", (partial(spg.solve, draw=draw), spg.SPGConfig))
    rj = jbatch.solve_batched_fused_compact("spg", jnp.asarray(A), jnp.asarray(b), phase1,
                                            proj=jproj, config=jcfg, bucket=bucket,
                                            host_fallback=host_fallback, keys=jk)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = batch.solve_batched_fused_compact("spg", At, bt, phase1, proj=proj_from_jax(jproj),
                                           config=config_from_jax(jcfg), bucket=bucket,
                                           host_fallback=host_fallback, keys=pk)
    conv = np.asarray(rj.converged)
    in_phase2 = int((np.asarray(rj.matvecs) > phase1).sum())
    assert conv.all() == host_fallback and (phase1 >= np.asarray(rj.matvecs)).any()
    # More stragglers than the bucket: the fallback finishes the overflow.
    assert in_phase2 > bucket if host_fallback else in_phase2 == bucket
    assert_lanes_match(rj, rt, ATOL["cone"])


def test_spg_default_keys_and_draw():
    """Without keys a batch draws from ``split_keys(0, B)``; the default
    draw is ``rng.uniform`` on the lane's key and iteration."""
    n = 24
    A, b = problem_from_numpy(*family(4, n, 14), "cpu", torch.float64)
    proj = proj_from_jax(jax_set("box", n))
    cfg = spg.SPGConfig(tol=1e-8, max_matvecs=2000)
    r = spg.solve(A, b, proj=proj, config=cfg)
    r_keys = spg.solve(A, b, proj=proj, config=cfg, keys=rng.split_keys(0, 4))
    r_draw = spg.solve(A, b, proj=proj, config=cfg,
                       draw=lambda k, it: rng.uniform(k, it, torch.float64))
    assert bool(r.converged.all())
    for other in (r_keys, r_draw):
        assert torch.equal(other.x, r.x) and torch.equal(other.matvecs, r.matvecs)
    r_other = spg.solve(A, b, proj=proj, config=cfg, keys=rng.split_keys(1, 4))
    assert not torch.equal(r_other.x, r.x)
    # A lane solved alone, with its own key, is the same lane (to the order
    # of the plain GEMV's sums, which may follow the batch size).
    r1 = spg.solve(A[2:3], b[2:3], proj=proj, config=cfg, keys=rng.split_keys(0, 4)[2:3])
    assert int(r1.matvecs[0]) == int(r.matvecs[2])
    np.testing.assert_allclose(r1.x[0].numpy(), r.x[2].numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="criterion"):
        spg.solve(A, b, config=spg.SPGConfig(criterion="dnorm"))


def test_config_and_registry():
    jcfg = JaxSPGConfig(tol=3e-7, max_matvecs=77, m=4, tau=0.4, sigma1=0.02, sigma2=0.7,
                        criterion="d_norm", trace_len=3)
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, spg.SPGConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert SOLVERS["spg"] == (spg.solve, spg.SPGConfig)


def test_readme_quick_start():
    """The README's quick start (3x3, box, tol 1e-6) at B=1: converged to
    [1, 0, 1]."""
    A = torch.tensor([[[2., -1., 0.], [-1., 2., -1.], [0., -1., 2.]]], dtype=torch.float64)
    b = -torch.einsum("bij,j->bi", A, torch.tensor([1., 0., 1.], dtype=torch.float64))
    proj = proj_from_jax(cq.box([-2., -2., -4.], [2., 2., 5.], dtype=jnp.float64))
    r = spg.solve(A, b, proj=proj, config=spg.SPGConfig(tol=1e-6, max_matvecs=5000))
    assert bool(r.converged.all())
    np.testing.assert_allclose(r.x.numpy(), [[1., 0., 1.]], atol=1e-5)


# ---- rng --------------------------------------------------------------------


def test_rng_same_seed_same_draws():
    k = rng.split_keys(5, 16)
    assert k.dtype == torch.int64 and k.shape == (16,)
    assert torch.equal(k, rng.split_keys(5, 16))
    assert len(set(k.tolist())) == 16
    assert not torch.equal(k, rng.split_keys(6, 16))
    it = torch.arange(16, dtype=torch.int32)
    assert torch.equal(rng.uniform(k, it), rng.uniform(k.clone(), it.clone()))


@pytest.mark.parametrize("position", [0, 3, 7])
def test_rng_lane_stream_does_not_depend_on_its_batch(position):
    """A lane draws the same stream alone and at any position of a batch of
    eight, whatever the other lanes' keys and iterations."""
    key = rng.split_keys(21, 1)
    others = rng.split_keys(22, 8)
    keys = others.clone()
    keys[position] = key[0]
    for t in range(40):
        its = torch.randint(0, 1000, (8,), generator=torch.Generator().manual_seed(t))
        its[position] = t
        alone = rng.uniform(key, torch.tensor([t]))
        assert torch.equal(rng.uniform(keys, its)[position], alone[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_rng_values_lie_in_unit_interval_with_uniform_moments(dtype):
    u = rng.uniform(rng.split_keys(3, 100_000), torch.zeros(100_000, dtype=torch.int32), dtype)
    assert u.dtype == dtype
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    u64 = u.double()
    assert abs(float(u64.mean()) - 0.5) < 0.01
    assert abs(float(u64.var()) - 1 / 12) < 0.01
    # Along one lane's iterations too.
    v = rng.uniform(rng.split_keys(4, 1).expand(100_000), torch.arange(100_000), dtype).double()
    assert abs(float(v.mean()) - 0.5) < 0.01 and abs(float(v.var()) - 1 / 12) < 0.01


def test_rng_fold_in_changes_the_stream():
    k = rng.split_keys(8, 64)
    it = torch.arange(64)
    k1, k2 = rng.fold_in(k, 1), rng.fold_in(k, 2)
    assert torch.equal(k1, rng.fold_in(k.clone(), 1))
    u, u1, u2 = (rng.uniform(x, it) for x in (k, k1, k2))
    assert not (u == u1).any() and not (u1 == u2).any()
    assert not bool(torch.isin(k1, k).any())


def test_rng_check_keys_refuses_malformed_keys():
    k = rng.split_keys(0, 4)
    assert rng.check_keys(k, 4, "cpu") is k
    with pytest.raises(ValueError, match="one per lane"):
        rng.check_keys(k[:3], 4, "cpu")
    with pytest.raises(TypeError, match="int64"):
        rng.check_keys(k.to(torch.int32), 4, "cpu")
    with pytest.raises(TypeError, match="int64"):
        rng.check_keys([1, 2, 3, 4], 4, "cpu")


@pytest.mark.cuda
def test_spg_on_cuda_matches_cpu():
    """SPG on a small cone batch on the card, in f32 through the GEMV
    kernel, against the same solve (same keys) on the CPU in f64: every lane
    converged, solutions within 6 tol, and each matvec a GEMV launch.  The
    draws are the same function of the keys on both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccqppy_tpu_torch.ops import gemv

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n, tol = 99, 1e-5
    A, b = problem_from_numpy(*family(8, n, 15, scale=1.0), "cpu", torch.float64)
    keys = rng.split_keys(1, 8)
    cfg = spg.SPGConfig(tol=tol, max_matvecs=2000)
    u64 = rng.uniform(keys, torch.arange(8))
    u32 = rng.uniform(keys.to(dev), torch.arange(8, device=dev), torch.float32)
    np.testing.assert_allclose(u32.cpu().numpy(), u64.numpy(), rtol=0, atol=2 ** -24)
    r64 = spg.solve(A, b, proj=proj_from_jax(jax_set("cone", n)), config=cfg, keys=keys)
    before = gemv.LAUNCHES
    r32 = spg.solve(A.float().to(dev), b.float().to(dev),
                    proj=proj_from_jax(jax_set("cone", n)).to(dev).float(), config=cfg,
                    keys=keys.to(dev))
    torch.cuda.synchronize()
    assert gemv.LAUNCHES - before >= int(r32.matvecs.max())
    assert bool(r32.converged.all()) and bool(r64.converged.all())
    np.testing.assert_allclose(r32.x.cpu().numpy(), r64.x.numpy(), rtol=0, atol=6 * tol)
