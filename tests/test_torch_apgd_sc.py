"""Port parity: estimate_spectral_bounds, SpectralDense and apgd.solve_sc
against ccqppy_tpu's, f64, per lane; and the caveat of the reference's
spectral bounds, recorded against eigvalsh.

The JAX side is ``solve_batched`` (vmap, exact per lane); the port runs
the same batch with lane masks.  The problems are the cone ensemble's
family at B=6, n=99 (33 Lorentz blocks of dimension 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccqppy_tpu.models import APGDSCConfig as JaxAPGDSCConfig
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.ops.linop import SpectralDense as JaxSpectralDense
from ccqppy_tpu.ops.linop import estimate_spectral_bounds as jax_bounds
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import apgd
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import SpectralDense, estimate_spectral_bounds
from ccqppy_tpu_torch.utils.convert import (config_from_jax, operator_from_jax,
                                            problem_from_numpy, proj_from_jax)

torch.set_num_threads(1)

B, N = 6, 99


def cone_family(B, n, seed, scale=1.0):
    """A = G G^T + n I; b = -A x_uncon, x_uncon ~ U(-scale, scale)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    return A, -np.einsum("bij,bj->bi", A, rng.uniform(-scale, scale, (B, n)))


def _jcone():
    return JP.blockwise(JP.lorentz_cone(1.0, dtype=jnp.float64), 3)


def assert_lanes_match(rj, rt, atol=1e-10):
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=atol)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=atol)


def test_spectral_bounds_match_jax():
    A, _ = cone_family(B, N, 0)
    Lj, muj = jax_bounds(jnp.asarray(A), iters=32)
    L, mu = estimate_spectral_bounds(torch.from_numpy(A), iters=32)
    assert L.shape == mu.shape == (B,) and L.dtype == torch.float64
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-12)
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), rtol=1e-12)
    before = gemv.LAUNCHES
    estimate_spectral_bounds(torch.from_numpy(A[:1]), iters=5, safety=0.1)
    assert gemv.LAUNCHES == before        # the CPU runs the plain GEMV


def _spectrum_family(ends, middle, n=40, B=4, seed=1):
    """A = Q diag(d) Q^T with d = ends and ``middle(n - 2)`` between them."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    d = np.concatenate([[ends[0]], middle(n - 2), [ends[1]]])
    return Q @ (d[:, None] * Q.transpose(0, 2, 1))


def test_spectral_bounds_against_eigvalsh():
    """The reference's estimates bound the spectrum only where both ends are
    well separated.  Power iteration approaches each end from inside the
    spectrum, so where an end is clustered the 2% margin does not cover
    the gap: on the Wishart family G G^T + n I (both ends clustered, by the
    Marchenko-Pastur law) both estimates stay within 3% of the ends but mu
    lies above lambda_min on 7 of these 8 lanes, and on a clustered bottom
    end mu lands well inside the cluster.  The
    port computes what the JAX package computes (ROADMAP queue 3)."""
    separated = _spectrum_family((1.0, 100.0), lambda k: np.linspace(50, 60, k))
    L, mu = estimate_spectral_bounds(torch.from_numpy(separated))
    w = np.linalg.eigvalsh(separated)
    assert (L.numpy() >= w[:, -1]).all() and (mu.numpy() <= w[:, 0]).all()

    A, _ = cone_family(8, N, 2)
    L, mu = estimate_spectral_bounds(torch.from_numpy(A))
    w = np.linalg.eigvalsh(A)
    r_L, r_mu = L.numpy() / w[:, -1], mu.numpy() / w[:, 0]
    assert (np.abs(r_L - 1) < 0.03).all() and (np.abs(r_mu - 1) < 0.03).all()
    assert (r_mu > 1).sum() == 7

    clustered = _spectrum_family((1.0, 100.0), lambda k: np.linspace(1.001, 1.2, k))
    L, mu = estimate_spectral_bounds(torch.from_numpy(clustered))
    w = np.linalg.eigvalsh(clustered)
    assert (L.numpy() >= w[:, -1]).all()
    assert (mu.numpy() > 1.02 * w[:, 0]).all()


def test_solve_sc_spectral_dense_matches_jax():
    A, b = cone_family(B, N, 3)
    jproj = _jcone()
    Lj, muj = jax_bounds(jnp.asarray(A))
    jop = JaxSpectralDense(jnp.asarray(A), Lj, muj)
    jcfg = JaxAPGDSCConfig(tol=1e-8, max_matvecs=2000, trace_len=16)
    rj = solve_batched("apgd_sc", jop, jnp.asarray(b), proj=jproj, config=jcfg)
    op = operator_from_jax(jop, "cpu", torch.float64)
    assert isinstance(op, SpectralDense)
    rt = apgd.solve_sc(op, torch.from_numpy(b), proj=proj_from_jax(jproj),
                       config=config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    assert len(set(np.asarray(rj.matvecs).tolist())) > 1       # lanes differ
    assert_lanes_match(rj, rt)
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-8,
                               atol=1e-14)


@pytest.mark.parametrize("restart", [True, False])
def test_solve_sc_raw_stack_fallback_matches_jax(restart):
    """A raw stack carries no mu: the solve estimates both ends in-solve
    with 2 bound_iters + 2 matvecs, charged to the budget."""
    A, b = cone_family(B, N, 4, scale=2.0)
    jproj = _jcone()
    jcfg = JaxAPGDSCConfig(tol=1e-8, max_matvecs=2000, restart=restart, bound_iters=20)
    rj = solve_batched("apgd_sc", jnp.asarray(A), jnp.asarray(b), proj=jproj, config=jcfg)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = apgd.solve_sc(At, bt, proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    assert int(rt.matvecs.min()) > 2 * 20 + 2
    assert_lanes_match(rj, rt)


def test_solve_sc_budget_and_warm_start_match_jax():
    """Budget exits report unconverged; an infeasible warm start is
    projected; the box family runs through the same solver."""
    A, b = cone_family(B, N, 5, scale=3.0)
    x0 = np.random.default_rng(6).uniform(-2, 2, (B, N))
    jproj = JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    Lj, muj = jax_bounds(jnp.asarray(A))
    jop = JaxSpectralDense(jnp.asarray(A), Lj, muj)
    for budget in (9, 2000):
        jcfg = JaxAPGDSCConfig(tol=1e-9, max_matvecs=budget)
        rj = solve_batched("apgd_sc", jop, jnp.asarray(b), x0=jnp.asarray(x0),
                           proj=jproj, config=jcfg)
        rt = apgd.solve_sc(operator_from_jax(jop, "cpu", torch.float64),
                           torch.from_numpy(b), x0=torch.from_numpy(x0),
                           proj=proj_from_jax(jproj), config=config_from_jax(jcfg))
        assert bool(np.asarray(rj.converged).all()) == (budget > 9)
        assert_lanes_match(rj, rt)


def test_classic_apgd_not_ported_and_config_carries_over():
    """The configs of the APGD family and SPG carry over field for field
    (classic APGD, APGD-AR and SPG are ported now: tests/test_torch_apgd.py,
    tests/test_torch_spg.py)."""
    from ccqppy_tpu.models import APGDConfig as JaxAPGDConfig
    from ccqppy_tpu.models import SPGConfig as JaxSPGConfig
    from ccqppy_tpu_torch.models import spg

    for jcfg, cls in (
            (JaxAPGDSCConfig(tol=3e-7, max_matvecs=77, restart=False, bound_iters=5),
             apgd.APGDSCConfig),
            (JaxAPGDConfig(tol=2e-6, max_matvecs=90, relax=0.8, anti_relaxation=True),
             apgd.APGDConfig),
            (JaxSPGConfig(tol=4e-6, max_matvecs=60, m=7, criterion="d_norm"), spg.SPGConfig)):
        cfg = config_from_jax(jcfg)
        assert type(cfg) is cls
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_spectral_dense_take_and_checks():
    A = torch.from_numpy(cone_family(4, 9, 7)[0])
    L, mu = estimate_spectral_bounds(A)
    op = SpectralDense(A, L, mu).take(torch.tensor([3, 1]))
    assert torch.equal(op.A, A[[3, 1]]) and torch.equal(op.L, L[[3, 1]])
    assert torch.equal(op.spectral_bounds()[1], mu[[3, 1]])
    with pytest.raises(ValueError):
        SpectralDense(A, L[:2], mu)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spectral_dense_matvec_on_cuda(cuda):
    """SpectralDense.matvec at the cone width n = 999 (rows not 16-byte
    aligned) against its plain version in f64."""
    gen = torch.Generator(device=cuda).manual_seed(999)
    A = torch.randn((8, 999, 999), generator=gen, device=cuda)
    x = torch.randn((8, 999), generator=gen, device=cuda)
    op = SpectralDense(A, torch.ones(8, device=cuda), torch.ones(8, device=cuda))
    before = gemv.LAUNCHES
    y = op.matvec(x)
    torch.cuda.synchronize()
    assert gemv.LAUNCHES == before + 1
    ref = gemv.batched_gemv_reference(A.double(), x.double())
    assert float((y.double() - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.cuda
def test_cone_solve_on_cuda_launches_the_kernel(cuda):
    """A small cone solve on the card: every matvec is a GEMV launch, and
    the result agrees with the f64 CPU solve."""
    A, b = cone_family(4, 99, 8)
    proj = proj_from_jax(_jcone())
    A64, b64 = problem_from_numpy(A, b, "cpu", torch.float64)
    A32, b32 = A64.float().to(cuda), b64.float().to(cuda)
    before = gemv.LAUNCHES
    L, mu = estimate_spectral_bounds(A32)
    cfg = apgd.APGDSCConfig(tol=1e-5, max_matvecs=2000)
    r = apgd.solve_sc(SpectralDense(A32, L, mu), b32,
                      proj=proj_from_jax(_jcone()).to(cuda).float(), config=cfg)
    torch.cuda.synchronize()
    assert bool(r.converged.all())
    assert gemv.LAUNCHES - before >= 66 + int(r.matvecs.max())
    r64 = apgd.solve_sc(SpectralDense(A64, *estimate_spectral_bounds(A64)), b64,
                        proj=proj, config=cfg)
    # Both within 3 n tol / lambda_min(A) = 3 tol of the optimum.
    np.testing.assert_allclose(r.x.cpu().numpy(), r64.x.numpy(), rtol=0, atol=6e-5)
