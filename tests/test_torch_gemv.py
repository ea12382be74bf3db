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


def _offset_view(t, offset):
    """t's values as a contiguous view ``offset`` elements into a larger
    buffer, so its base is aligned as the offset makes it.  The buffer
    holds NaN before the view and in the 16 bytes after it, so a result
    that used any element outside the view would be NaN."""
    pad = 16 // t.element_size()
    buf = torch.full((offset + t.numel() + pad,), torch.nan, dtype=t.dtype, device=t.device)
    buf[offset:offset + t.numel()] = t.reshape(-1)
    view = buf[offset:offset + t.numel()].view(t.shape)
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


def _bits(y):
    return y.view(torch.int32)


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


def test_rejects_mismatched_devices():
    with pytest.raises(ValueError):
        gemv.batched_gemv(torch.zeros((1, 2, 2)), torch.zeros((1, 2), device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_plain_version_on_offset_views_is_bitwise(offset, dtype):
    """A and x as contiguous views at a storage offset give bitwise the y of
    their aligned copies, as the kernel must on the card."""
    A, x = _inputs(3, 37, 6)
    A, x = torch.from_numpy(A).to(dtype), torch.from_numpy(x)
    y = gemv.batched_gemv(_offset_view(A, offset), _offset_view(x, offset))
    assert torch.equal(_bits(y), _bits(gemv.batched_gemv(A, x)))


@pytest.mark.parametrize("A,x,error", [
    (torch.zeros((2, 8, 8), dtype=torch.float64), torch.zeros((2, 8)), TypeError),
    (torch.zeros((2, 8, 8), dtype=torch.float16), torch.zeros((2, 8)), TypeError),
    (torch.zeros((2, 8, 8), dtype=torch.bfloat16), torch.zeros((2, 8), dtype=torch.float64),
     TypeError),
    (torch.zeros((2, 8, 8)), torch.zeros((2, 8), dtype=torch.bfloat16), TypeError),
    (torch.zeros((2, 8, 8)).mT, torch.zeros((2, 8)), ValueError),
    (torch.zeros((2, 8, 8)), torch.zeros((2, 16))[:, ::2], ValueError),
], ids=["f64-A", "f16-A", "f64-x", "bf16-x", "strided-A", "strided-x"])
def test_kernel_operand_checks_raise(A, x, error):
    """What a CUDA tensor must be before the kernel launches; the same
    checks run on CPU tensors here."""
    with pytest.raises(error):
        gemv._check_kernel_operands(A, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 3])
def test_kernel_operand_checks_pass(offset, dtype):
    """Contiguous f32 or bf16 A and f32 x pass at any storage offset."""
    A = _offset_view(torch.zeros((2, 8, 8), dtype=dtype), offset)
    gemv._check_kernel_operands(A, _offset_view(torch.zeros((2, 8)), offset))


@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_operand_checks_pass_f64(offset):
    """Contiguous f64 x with f64 A (the f64 instance) or f32 A (the (f32,
    f64) instance) passes at any storage offset; bf16 A with f64 x, the
    f64-x pair without an instance, names the gap."""
    A = _offset_view(torch.zeros((2, 8, 8), dtype=torch.float64), offset)
    x = _offset_view(torch.zeros((2, 8), dtype=torch.float64), offset)
    gemv._check_kernel_operands(A, x)
    gemv._check_kernel_operands(_offset_view(torch.zeros((2, 8, 8)), offset), x)
    with pytest.raises(TypeError, match="no instance"):
        gemv._check_kernel_operands(A.to(torch.bfloat16), x)


KERNEL_TOL = 1e-5   # max|y - y_ref| / max|y_ref| against the f64 plain version
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _launch(A, x):
    """One kernel launch, synchronised, that adds exactly 1 to the count."""
    before = gemv.LAUNCHES
    y = gemv.batched_gemv(A, x)
    torch.cuda.synchronize()
    assert gemv.LAUNCHES == before + 1
    assert y.dtype == torch.float32 and y.shape == x.shape
    return y


def _plain_f64(A, x):
    """The plain version in f64; for bf16 A of the bf16-rounded x, as the
    kernel reads it."""
    if A.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    return gemv.batched_gemv_reference(A.double(), x.double())


def _random(cuda, B, n, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    A = torch.randn((B, n, n), generator=gen, device=cuda).to(dtype)
    return A, torch.randn((B, n), generator=gen, device=cuda)


# Every n through one code path: tiny rows (all at the tensor's ends),
# rows not 16-byte aligned (37, 999, 1025, 2049), several column tiles
# (1025 and up in f32, 2049 and up in bf16); the phase-2 bucket; a batch
# past 65535.
SHAPES = [(B, n) for B in (1, 3) for n in (1, 2, 3, 31, 33, 999, 1000, 1025, 2049, 9001)]
SHAPES += [(3, 37), (4, 256), (2, 1000), (41, 999), (41, 1000), (70000, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", SHAPES, ids=[f"B{B}-n{n}" for B, n in SHAPES])
@DTYPES
def test_kernel_matches_plain_on_cuda(cuda, B, n, dtype):
    A, x = _random(cuda, B, n, dtype, B * 10007 + n)
    y = _launch(A, x)
    ref = _plain_f64(A, x)
    assert float((y.double() - ref).abs().max() / ref.abs().max()) < KERNEL_TOL
    assert torch.equal(_bits(_launch(A, x)), _bits(y)), "two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 1), (1, 3), (3, 33), (3, 999), (2, 1000), (2, 2049)])
@DTYPES
def test_kernel_storage_offset_bitwise_on_cuda(cuda, B, n, dtype):
    """Views of A at every element offset within 16 bytes and of x at 0-3
    floats, with NaN around both: y is bitwise the same as on aligned A and
    x, so no copied span brings in a value from outside A or x."""
    A, x = _random(cuda, B, n, dtype, n)
    y = _launch(A, x)
    ref = _plain_f64(A, x)
    assert float((y.double() - ref).abs().max() / ref.abs().max()) < KERNEL_TOL
    for a_off in range(16 // A.element_size()):
        for x_off in range(4):
            y_off = _launch(_offset_view(A, a_off), _offset_view(x, x_off))
            assert torch.equal(_bits(y_off), _bits(y)), (a_off, x_off)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@DTYPES
def test_kernel_nan_stays_in_its_row_on_cuda(cuda, offset, dtype):
    """A NaN in A[b, r, c] makes y[b, r] NaN and no other entry; the spots
    include the first and last element of A and both sides of a 16-row
    block."""
    B, n = 3, 999
    A, x = _random(cuda, B, n, dtype, 7)
    spots = [(0, 0, 0), (0, 15, 998), (1, 16, 0), (1, 500, 3), (2, 998, 998)]
    for b, r, c in spots:
        A[b, r, c] = torch.nan
    y = _launch(_offset_view(A, offset), _offset_view(x, offset))
    expected = torch.zeros((B, n), dtype=torch.bool, device=cuda)
    for b, r, _ in spots:
        expected[b, r] = True
    assert torch.equal(torch.isnan(y), expected)


@pytest.mark.cuda
def test_kernel_rejects_f64_and_strided_on_cuda(cuda):
    """f64 A and x are the f64 instance's pair, f32 A and f64 x the (f32,
    f64) instance's; f64 A with f32 x and bf16 A with f64 x have no
    instance and raise, as a strided operand does."""
    A = torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda)
    x = torch.zeros((2, 8), dtype=torch.float64, device=cuda)
    for a, v in ((A, x.float()), (A.to(torch.bfloat16), x)):
        with pytest.raises(TypeError):
            gemv.batched_gemv(a, v)
    with pytest.raises(ValueError):
        gemv.batched_gemv(A.float().mT, x.float())
    with pytest.raises(ValueError):
        gemv.batched_gemv(A.mT, x)


F32_F64_SHAPES = [(1, 1), (1, 3), (3, 33), (3, 999), (2, 1025), (41, 1000), (1, 9999)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", F32_F64_SHAPES, ids=[f"B{B}-n{n}" for B, n in F32_F64_SHAPES])
def test_f32_f64_instance_on_cuda(cuda, B, n):
    """The (f32 A, f64 x) instance, MPRGP's f64 sweep: each f32 element
    times an f64 x in one fused multiply-add, summed in f64, so against the
    plain f64 version it errs by f64 rounding alone (1e-12 of the largest
    |y|); bitwise the same from launch to launch and at storage offsets
    with NaN around A and x; counted in ``LAUNCHES_F32_F64`` and not in
    ``LAUNCHES_F64``."""
    A, x = _random(cuda, B, n, torch.float32, 7 * n + B)
    x = x.double() * (1 + 2.0**-30)        # bits below f32's
    before = (gemv.LAUNCHES, gemv.LAUNCHES_F32_F64, gemv.LAUNCHES_F64)
    y = gemv.batched_gemv(A, x)
    torch.cuda.synchronize()
    assert (gemv.LAUNCHES, gemv.LAUNCHES_F32_F64, gemv.LAUNCHES_F64) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert y.dtype == torch.float64 and y.shape == x.shape
    ref = gemv.batched_gemv_reference(A, x)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-12
    for a_off, x_off in ((0, 1), (1, 0), (3, 1)):
        y_off = gemv.batched_gemv(_offset_view(A, a_off), _offset_view(x, x_off))
        assert torch.equal(y_off.view(torch.int64), y.view(torch.int64)), (a_off, x_off)


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
