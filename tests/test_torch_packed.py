"""Port parity: the packed symmetric operator and the packed mode, f64.

``SymmetricPackedDense`` against the JAX operator of the same name (whose
matvec runs the Pallas ``symv_packed`` in interpret mode on the CPU), and
PCG through it, per lane, against the JAX package's packed runs.  The
port's operator is batched; the JAX one is applied per lane under
``jax.vmap``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.ops.linop import DenseOperator as JaxDense
from ccqppy_tpu.ops.linop import SymmetricPackedDense as JaxPacked
from ccqppy_tpu.parallel.batch import solve_batched as jax_solve_batched
from ccqppy_tpu.parallel.batch import \
    solve_batched_fused_compact as jax_fused_compact
from ccqppy_tpu_torch.ops.linop import DenseOperator, SymmetricPackedDense
from ccqppy_tpu_torch.parallel import batch
from ccqppy_tpu_torch.utils.convert import (config_from_jax, operator_from_jax,
                                            problem_from_numpy, proj_from_jax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, N, TILE = 6, 200, 128     # n padded to 256: 3 upper tiles


def _wishart(B, n, seed, scale):
    """A = G G^T + n I, b = -A x_uncon with x_uncon ~ U(-scale, scale)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    return A, -np.einsum("bij,bj->bi", A, rng.uniform(-scale, scale, (B, n)))


def _assert_lanes_match(rj, rt):
    """converged, matvec and iteration counts equal per lane; x and the
    residual within 1e-10 (the packed sums differ from the JAX kernel's only
    in rounding, ~1e-13 relative)."""
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual), rtol=0, atol=1e-10)


def test_from_dense_matches_jax():
    """n=300 at tile 128 pads to 384: Ap and diag bitwise, the operator's
    methods per lane."""
    A, _ = _wishart(2, 300, 1, 1.0)
    x = np.random.default_rng(2).standard_normal((2, 300))
    jop = JaxPacked.from_dense(jnp.asarray(A), tile=TILE)
    op = SymmetricPackedDense.from_dense(torch.from_numpy(A), tile=TILE)
    assert op.Ap.shape == (2, 6, TILE, TILE) and op.npad == 384 and op.n == 300
    np.testing.assert_array_equal(op.Ap.numpy(), np.asarray(jop.Ap))
    np.testing.assert_array_equal(op.diag.numpy(), np.asarray(jop.diag))
    y = op.matvec(torch.from_numpy(x))
    assert y.shape == (2, 300)
    yj = jax.vmap(lambda o, v: o.matvec(v))(jop, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(y.numpy(), np.einsum("bij,bj->bi", A, x), rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(op.diagonal().numpy(),
                                  np.asarray(jax.vmap(lambda o: o.diagonal())(jop)))
    np.testing.assert_allclose(op.inf_norm().numpy(),
                               np.asarray(jax.vmap(lambda o: o.inf_norm())(jop)), rtol=1e-14)
    np.testing.assert_allclose(op.inf_norm().numpy(), np.abs(A).sum(-1).max(-1), rtol=1e-14)


def test_take_restricts_to_lanes():
    A, _ = _wishart(4, 130, 3, 1.0)
    op = SymmetricPackedDense.from_dense(torch.from_numpy(A), tile=TILE)
    idx = torch.tensor([3, 1])
    sub = op.take(idx)
    assert (sub.n, sub.tile, sub.npad) == (op.n, op.tile, op.npad)
    assert torch.equal(sub.Ap, op.Ap[idx]) and torch.equal(sub.diag, op.diag[idx])
    dense = DenseOperator(torch.from_numpy(A)).take(idx)
    assert torch.equal(dense.A, torch.from_numpy(A)[idx])
    with pytest.raises(ValueError):
        SymmetricPackedDense(op.Ap[:, :2], op.diag, op.n, op.tile)


@pytest.mark.parametrize("batched", [True, False])
def test_operator_from_jax_round_trips(batched):
    A, _ = _wishart(2, 150, 4, 1.0)
    A = A if batched else A[0]
    jpk = JaxPacked.from_dense(jnp.asarray(A), tile=TILE)
    op = operator_from_jax(jpk, "cpu", torch.float64)
    assert isinstance(op, SymmetricPackedDense) and (op.n, op.tile) == (150, TILE)
    Ap, diag = np.asarray(jpk.Ap), np.asarray(jpk.diag)
    np.testing.assert_array_equal(op.Ap.numpy(), Ap if batched else Ap[None])
    np.testing.assert_array_equal(op.diag.numpy(), diag if batched else diag[None])
    back = JaxPacked(jnp.asarray(op.Ap.numpy()), jnp.asarray(op.diag.numpy()), op.n, op.tile)
    np.testing.assert_array_equal(np.asarray(back.Ap).reshape(Ap.shape), Ap)
    dense = operator_from_jax(JaxDense(jnp.asarray(A)), "cpu", torch.float32)
    assert isinstance(dense, DenseOperator) and dense.A.dtype == torch.float32
    np.testing.assert_array_equal(dense.A.numpy(), (A if batched else A[None]).astype(np.float32))
    with pytest.raises(NotImplementedError):
        operator_from_jax(object(), "cpu", torch.float64)


def _packed_problem(seed):
    """Constraints bind: x_uncon ~ U(-1.5, 1.5) against the box [-1, 1]."""
    A, b = _wishart(B, N, seed, 1.5)
    jop = JaxPacked.from_dense(jnp.asarray(A), tile=TILE)
    jproj = cq.box(-jnp.ones(N), jnp.ones(N), dtype=jnp.float64)
    _, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    return jop, jnp.asarray(b), jproj, operator_from_jax(jop, "cpu", torch.float64), bt


def test_pcg_through_packed_operator_matches_jax():
    jop, bj, jproj, op, bt = _packed_problem(11)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=300, precond="jacobi")
    rj = jax_solve_batched("pcg", jop, bj, proj=jproj, config=jcfg)
    rt = batch.solve_batched("pcg", op, bt, proj=proj_from_jax(jproj),
                             config=config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    _assert_lanes_match(rj, rt)


@pytest.mark.parametrize("host_fallback", [False, True])
def test_fused_compact_through_packed_operator_matches_jax(host_fallback):
    """Phase 1 at 12 matvecs, a bucket of 4: every lane misses phase 1, two
    overflow the bucket and either keep their phase-1 state or are finished
    by the host fallback."""
    jop, bj, jproj, op, bt = _packed_problem(12)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=300)
    rj = jax_fused_compact("pcg", jop, bj, 12, proj=jproj, config=jcfg, bucket=4,
                           host_fallback=host_fallback)
    rt = batch.solve_batched_fused_compact("pcg", op, bt, 12, proj=proj_from_jax(jproj),
                                           config=config_from_jax(jcfg), bucket=4,
                                           host_fallback=host_fallback)
    assert np.asarray(rj.converged).sum() == (B if host_fallback else 4)
    _assert_lanes_match(rj, rt)


def test_packed_mode_matches_jax_wiring():
    """chip_smoke.py's packed mode (Jacobi warm start from the operator's
    diagonal, phase 1 at PHASE1, a BUCKET-lane bucket) against the JAX
    package wired the same way, on bench.py's family."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    A, b = _wishart(B, N, 13, 1.0)
    b = b + 1e-3 * np.random.default_rng(14).standard_normal((B, N))
    jop = JaxPacked.from_dense(jnp.asarray(A), tile=TILE)
    bj = jnp.asarray(b)
    jproj = cq.box(-jnp.ones(N), jnp.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=cs.TOL, max_matvecs=cs.BUDGET)
    rj = jax_fused_compact("pcg", jop, bj, cs.PHASE1, x0=jnp.clip(-bj / jop.diag, -1.0, 1.0),
                           proj=jproj, config=jcfg, bucket=cs.BUCKET, host_fallback=False)
    op = SymmetricPackedDense.from_dense(torch.from_numpy(A), tile=TILE)
    rt = cs.run_packed(op, torch.from_numpy(b), proj_from_jax(jproj), config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    _assert_lanes_match(rj, rt)
