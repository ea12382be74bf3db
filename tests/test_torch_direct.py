"""Port parity: ccqppy_tpu_torch.models.direct against ccqppy_tpu's, f64.

Both packages get the same inverse (numpy's), so the warm starts agree and
the per-lane polish paths can be compared.  Half the lanes have optima
outside the box, so their projected inverse guess is not optimal and the
compacted PCG polish runs for them.
"""
import numpy as np
import torch

import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.models import direct as jax_direct
from ccqppy_tpu_torch.models import direct
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)

torch.set_num_threads(1)

B, N = 8, 64


def _problem(seed=31):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, N, N))
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    xu = rng.uniform(-0.9, 0.9, (B, N))
    xu[B // 2:] *= 2.0
    return A, -np.einsum("bij,bj->bi", A, xu)


def test_spd_inverse_matches_numpy():
    A, _ = _problem()
    inv = direct.spd_inverse_batch(torch.from_numpy(A))
    assert inv.is_contiguous()
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(A), rtol=1e-10, atol=1e-16)


def test_direct_x0_matches_jax():
    A, b = _problem()
    Ainv = np.linalg.inv(A)
    jproj = cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    xj = jax_direct.direct_x0(jnp.asarray(Ainv), jnp.asarray(b), jproj)
    xt = direct.direct_x0(torch.from_numpy(Ainv), torch.from_numpy(b), proj_from_jax(jproj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)


def test_solve_direct_batched_matches_jax():
    A, b = _problem()
    Ainv = np.linalg.inv(A)
    jproj = cq.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=400)
    rj = jax_direct.solve_direct_batched(jnp.asarray(Ainv), jnp.asarray(A),
                                         jnp.asarray(b), jproj, jcfg, phase1=3,
                                         bucket=2, host_fallback=True)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    rt = direct.solve_direct_batched(torch.from_numpy(Ainv), At, bt, proj_from_jax(jproj),
                                     config_from_jax(jcfg), phase1=3, bucket=2,
                                     host_fallback=True)
    mv = np.asarray(rj.matvecs)
    assert (mv[:B // 2] == 2).all() and (mv[B // 2:] > 3).all()   # +1: the inverse apply
    np.testing.assert_array_equal(rt.matvecs.numpy(), mv)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=1e-12)
