"""Port parity: ccqppy_tpu_torch.ops.gemv against the Pallas batched_gemv.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_pallas_kernels.py does.  The
CUDA kernel itself is held against the plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.ops.linop import DenseOperator as JaxDense
from ccqppy_tpu.ops.pallas_kernels import batched_gemv as jax_gemv
from ccqppy_tpu.ops.pallas_kernels import padded_batched_gemv
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import DenseOperator, as_operator

torch.set_num_threads(1)


def _inputs(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    x = rng.standard_normal((B, n)).astype(np.float32)
    return A, x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_f32_matches_pallas_interpret():
    A, x = _inputs(4, 256, 0)
    y = gemv.batched_gemv(torch.from_numpy(A), torch.from_numpy(x))
    ref = jax_gemv(jnp.asarray(A), jnp.asarray(x), interpret=True)
    assert y.dtype == torch.float32 and y.shape == (4, 256)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-4)


def test_ragged_n_matches_padded_interpret():
    A, x = _inputs(3, 200, 1)   # n not a multiple of 128: the TPU pads
    y = gemv.batched_gemv(torch.from_numpy(A), torch.from_numpy(x))
    ref = padded_batched_gemv(jnp.asarray(A), jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-4)


def test_bf16_matches_pallas_interpret():
    """Both round A and x to bf16 and accumulate in f32: only the order of
    summation differs."""
    A, x = _inputs(3, 256, 2)
    A = A + A.transpose(0, 2, 1)
    y = gemv.batched_gemv(torch.from_numpy(A).to(torch.bfloat16), torch.from_numpy(x))
    ref = np.asarray(jax_gemv(jnp.asarray(A).astype(jnp.bfloat16), jnp.asarray(x),
                              interpret=True))
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() < 1e-5


def test_f64_plain_version_is_f64():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, 50, 50))
    x = rng.standard_normal((2, 50))
    y = gemv.batched_gemv(torch.from_numpy(A), torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.einsum("bij,bj->bi", A, x), rtol=1e-13)


def test_cpu_never_counts_a_launch():
    A, x = _inputs(2, 64, 4)
    before = gemv.LAUNCHES
    gemv.batched_gemv(torch.from_numpy(A), torch.from_numpy(x))
    assert gemv.LAUNCHES == before


@pytest.mark.parametrize("shape_A,shape_x", [((2, 3, 4), (2, 3)),
                                             ((2, 3, 3), (2, 4)),
                                             ((3, 3), (3,))])
def test_rejects_bad_shapes(shape_A, shape_x):
    with pytest.raises(ValueError):
        gemv.batched_gemv(torch.zeros(shape_A), torch.zeros(shape_x))


def test_rejects_other_devices():
    with pytest.raises(ValueError):
        gemv.batched_gemv(torch.zeros((1, 2, 2), device="meta"),
                          torch.zeros((1, 2), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(3, 999), (3, 37), (4, 256), (2, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda, B, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(B * n)
    A = torch.randn((B, n, n), generator=gen, device=cuda).to(dtype)
    x = torch.randn((B, n), generator=gen, device=cuda)
    before = gemv.LAUNCHES
    y = gemv.batched_gemv(A, x)
    torch.cuda.synchronize()
    assert gemv.LAUNCHES == before + 1
    ref = gemv.batched_gemv_reference(A.double(), x.double()) if dtype == torch.float32 \
        else gemv.batched_gemv_reference(A, x).double()
    assert float((y.double() - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.cuda
def test_kernel_rejects_f64_and_strided_on_cuda(cuda):
    A = torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda)
    x = torch.zeros((2, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        gemv.batched_gemv(A, x)
    with pytest.raises(ValueError):
        gemv.batched_gemv(A.float().mT, x.float())


def test_dense_operator_matches_jax_per_lane():
    """DenseOperator's matvec runs through batched_gemv; its reductions are
    per lane, as the JAX operator's are under vmap."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 40, 40))
    x, y = rng.standard_normal((3, 40)), rng.standard_normal((3, 40))
    op = as_operator(torch.from_numpy(A))
    assert isinstance(op, DenseOperator) and as_operator(op) is op
    Aj, xj, yj = jnp.asarray(A), jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(lambda a, v: JaxDense(a).matvec(v))(Aj, xj)),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(op.diagonal().numpy(),
                                  np.asarray(jax.vmap(lambda a: JaxDense(a).diagonal())(Aj)))
    np.testing.assert_allclose(op.inf_norm().numpy(),
                               np.asarray(jax.vmap(lambda a: JaxDense(a).inf_norm())(Aj)),
                               rtol=1e-14)
    np.testing.assert_allclose(op.dot(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jax.vmap(lambda a, u, v: JaxDense(a).dot(u, v))(Aj, xj, yj)),
                               rtol=1e-13)
    with pytest.raises(ValueError):
        DenseOperator(torch.zeros(4, 4))
