"""Port parity: ccqppy_tpu_torch.ops.symv against the Pallas symv kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_pallas_kernels.py does,
here in f64.  The CUDA kernel itself is held against the plain versions on
the card (tests marked ``cuda``), at the shapes chip_smoke.py checks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.ops import pallas_kernels as pk
from ccqppy_tpu_torch.ops import symv

torch.set_num_threads(1)

B, N = 3, 512
REL = 1e-12     # f64: the two sides differ only in the order of the sums


def _sym_batch(B=B, n=N, seed=4, dtype=np.float64):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    return (G + G.transpose(0, 2, 1)).astype(dtype), rng.standard_normal((B, n)).astype(dtype)


def _rel(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    return np.abs(y - ref).max() / np.abs(ref).max()


def _poison_lower(A, tile, value=np.nan):
    """Fill the strictly-lower off-diagonal tiles of a (B, n, n) copy."""
    A = A.copy()
    for i in range(A.shape[-1] // tile):
        A[:, (i + 1) * tile:, i * tile:(i + 1) * tile] = value
    return A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 8])
def test_upper_tile_tables_match_jax(nt):
    ii, jj = symv.upper_tile_tables(nt)
    ii_j, jj_j = pk._upper_tile_tables(nt)
    np.testing.assert_array_equal(ii.numpy(), ii_j)
    np.testing.assert_array_equal(jj.numpy(), jj_j)
    assert len(ii) == symv.num_tiles(nt)


@pytest.mark.parametrize("tile", [128, 256])
def test_pack_symmetric_bitwise_matches_jax(tile):
    A, _ = _sym_batch()
    Ap = symv.pack_symmetric(torch.from_numpy(A), tile)
    assert Ap.is_contiguous() and Ap.shape == (B, symv.num_tiles(N // tile), tile, tile)
    np.testing.assert_array_equal(Ap.numpy(), np.asarray(pk.pack_symmetric(jnp.asarray(A), tile=tile)))


@pytest.mark.parametrize("tile", [128, 256])
def test_plain_versions_match_pallas_interpret(tile):
    A, x = _sym_batch()
    Aj, xj = jnp.asarray(A), jnp.asarray(x)
    At, xt = torch.from_numpy(A), torch.from_numpy(x)
    Apj = pk.pack_symmetric(Aj, tile=tile)
    Ap = symv.pack_symmetric(At, tile)

    full = symv.batched_symv(At, xt, tile)
    assert full.dtype == torch.float64 and full.shape == (B, N)
    assert _rel(full, pk.batched_symv(Aj, xj, tile=tile, interpret=True)) < REL
    assert _rel(symv.batched_symv_packed(Ap, xt),
                pk.batched_symv_packed(Apj, xj, interpret=True)) < REL
    single = np.stack([symv.symv_packed(Ap[b], xt[b]).numpy() for b in range(B)])
    assert _rel(single, jax.vmap(lambda a, v: pk.symv_packed(a, v, interpret=True))(Apj, xj)) < REL
    # ... and all three are the symmetric matvec.
    ref = np.einsum("bij,bj->bi", A, x)
    assert _rel(full, ref) < REL
    assert _rel(symv.batched_symv_packed_reference(Ap, xt, N), ref) < REL
    assert _rel(symv.symv_packed_reference(Ap[1], xt[1], N), ref[1]) < REL


def test_full_layout_ignores_lower_tiles():
    """Garbage in the strictly-lower off-diagonal tiles changes nothing, for
    the port and for JAX (whose kernel never fetches those blocks)."""
    tile = 128
    A, x = _sym_batch(seed=5)
    clean = symv.batched_symv(torch.from_numpy(A), torch.from_numpy(x), tile)
    poisoned = _poison_lower(A, tile)
    y = symv.batched_symv(torch.from_numpy(poisoned), torch.from_numpy(x), tile)
    assert torch.equal(y, clean)
    yj = pk.batched_symv(jnp.asarray(poisoned), jnp.asarray(x), tile=tile, interpret=True)
    assert np.isfinite(np.asarray(yj)).all() and _rel(y, yj) < REL


def test_f32_plain_version_is_f32():
    A, x = _sym_batch(B=2, n=256, dtype=np.float32)
    y = symv.batched_symv_packed(symv.pack_symmetric(torch.from_numpy(A), 128),
                                 torch.from_numpy(x).double())
    assert y.dtype == torch.float32
    assert _rel(y, np.einsum("bij,bj->bi", A.astype(np.float64), x.astype(np.float64))) < 1e-5


def test_cpu_never_counts_a_launch():
    A, x = _sym_batch(B=1, n=256)
    At, xt = torch.from_numpy(A), torch.from_numpy(x)
    Ap = symv.pack_symmetric(At, 128)
    before = dict(symv.LAUNCHES)
    symv.batched_symv(At, xt, 128)
    symv.batched_symv_packed(Ap, xt)
    symv.symv_packed(Ap[0], xt[0])
    assert symv.LAUNCHES == before


def test_wrappers_reject_n_not_a_multiple_of_tile():
    A, x = _sym_batch(B=1, n=256)
    At, xt = torch.from_numpy(A), torch.from_numpy(x)
    Ap = symv.pack_symmetric(At, 128)
    with pytest.raises(ValueError):
        symv.batched_symv(At, xt, 96)
    with pytest.raises(ValueError):
        symv.pack_symmetric(At, 96)
    with pytest.raises(ValueError):      # 200 % 128 != 0
        symv.batched_symv_packed(Ap, xt[:, :200], n=200)
    with pytest.raises(ValueError):
        symv.symv_packed(Ap[0], xt[0, :200], n=200)
    with pytest.raises(ValueError):      # 384 has 6 tiles, Ap has 3
        symv.batched_symv_packed(Ap, torch.zeros((1, 384), dtype=torch.float64))


def test_kernel_input_checks():
    """The checks every CUDA launch runs first: f32, contiguous, aligned."""
    A = torch.zeros((2, 3, 128, 128))
    x = torch.zeros((2, 256))
    symv.check_kernel_inputs(A, x)
    with pytest.raises(TypeError):
        symv.check_kernel_inputs(A.double(), x.double())
    with pytest.raises(TypeError):
        symv.check_kernel_inputs(A, x.double())
    with pytest.raises(ValueError):
        symv.check_kernel_inputs(A.transpose(2, 3), x)
    with pytest.raises(ValueError):
        symv.check_kernel_inputs(A, torch.zeros(2 * 256 + 1)[1:].view(2, 256))
    with pytest.raises(ValueError):
        symv.batched_symv_packed(A.to("meta"), x.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,tile", [(3, 512, 128), (3, 512, 256), (2, 1024, 512),
                                      (2048, 1024, 256)])
def test_kernel_matches_plain_on_cuda(cuda, B, n, tile):
    """Each entry point against its f64 plain version, bitwise repeatable,
    and blind to NaN in the full layout's strictly-lower tiles."""
    gen = torch.Generator(device=cuda).manual_seed(B + n + tile)
    G = torch.randn((B, n, n), generator=gen, device=cuda)
    A = G + G.mT
    del G
    x = torch.randn((B, n), generator=gen, device=cuda)
    Ap = symv.pack_symmetric(A, tile)
    chunk = 256
    before = dict(symv.LAUNCHES)
    cases = [
        (lambda: symv.batched_symv(A, x, tile),
         lambda s: symv.batched_symv_reference(A[s].double(), x[s].double(), tile)),
        (lambda: symv.batched_symv_packed(Ap, x),
         lambda s: symv.batched_symv_packed_reference(Ap[s].double(), x[s].double(), n)),
        (lambda: symv.symv_packed(Ap[0], x[0])[None],
         lambda s: symv.symv_packed_reference(Ap[0].double(), x[0].double(), n)[None]),
    ]
    outs = []
    for fn, plain in cases:
        y = fn()
        assert torch.equal(y.view(torch.int32), fn().view(torch.int32))
        ref = torch.cat([plain(slice(i, i + chunk)) for i in range(0, y.shape[0], chunk)])
        assert float((y.double() - ref).abs().max() / ref.abs().max()) < 1e-5
        outs.append(y)
    torch.cuda.synchronize()
    # Each wrapper counts its own launches, two each, and only its own.
    assert symv.LAUNCHES == {k: v + 2 for k, v in before.items()}
    for i in range(n // tile):
        A[:, (i + 1) * tile:, i * tile:(i + 1) * tile] = torch.nan
    assert torch.equal(symv.batched_symv(A, x, tile).view(torch.int32), outs[0].view(torch.int32))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take_on_cuda(cuda):
    A = torch.zeros((2, 256, 256), dtype=torch.float64, device=cuda)
    x = torch.zeros((2, 256), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        symv.batched_symv(A, x, 128)
    with pytest.raises(ValueError):
        symv.batched_symv(A.float().mT, x.float(), 128)
    with pytest.raises(ValueError):      # a tile the kernel is not built for
        symv.batched_symv(A.float(), x.float(), 64)
    with pytest.raises(ValueError):
        symv.batched_symv(A.float(), x.float(), 96)
