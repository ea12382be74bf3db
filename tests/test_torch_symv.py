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


ROW_SLICE_CASES = [(B, T, tile, sms) for sms in (1, 8, 114, 132)
                   for B, T, tile in ((2048, 10, 256), (1, 10, 256), (1, 10, 128), (1, 3, 512),
                                      (3, 3, 256), (26, 10, 256), (27, 10, 256), (1, 1, 128))]


@pytest.mark.parametrize("B,T,tile,sms", ROW_SLICE_CASES)
def test_row_slices_fill_the_card(B, T, tile, sms):
    """S = 1 wherever B * T blocks already put one on every SM; otherwise
    the least power of two that does, unless slices of MIN_SLICE_ROWS rows
    come first."""
    S = symv.row_slices(B, T, tile, sms)
    assert S >= 1 and S & (S - 1) == 0 and tile // S >= min(tile, symv.MIN_SLICE_ROWS)
    if B * T >= sms:
        assert S == 1
    else:
        assert B * T * (S // 2) < sms
        assert B * T * S >= sms or tile // S == symv.MIN_SLICE_ROWS


def test_row_slices_at_the_main_shapes():
    """On 132 SMs: the packed mode's (2048, 1024, 256) keeps one slice; one
    problem at n = 1024, tile 256 (10 tiles) takes 4 slices of 64 rows, 40
    blocks; at tile 512 (3 tiles) 8; a bucket of 13 lanes 2."""
    assert symv.row_slices(2048, 10, 256, 132) == 1
    assert symv.row_slices(1, 10, 256, 132) == 4
    assert symv.row_slices(1, 3, 512, 132) == 8
    assert symv.row_slices(13, 10, 256, 132) == 2


def _two_pass(Ap, x, n, slices):
    """The kernel's two passes, written out in PyTorch over the scratch
    layout ``scratch_shape``: pass 1 writes slot 0 (the row partials) and
    slot 1 + s (slice s's column partial) of every (problem, tile); pass 2
    sums, per output segment, each tile (i, s < i)'s column partials in
    slice order, then the row partials of the tiles (s, j >= s)."""
    B, T, tile, _ = Ap.shape
    nt = n // tile
    part = torch.full(symv.scratch_shape(B, T, slices, tile), torch.nan, dtype=Ap.dtype)
    xs = x.view(B, nt, tile)
    rows = tile // slices
    ii, jj = symv.upper_tile_tables(nt)
    for t, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        for sl in range(slices):
            r = slice(sl * rows, (sl + 1) * rows)
            part[:, t, 0, r] = torch.einsum("brc,bc->br", Ap[:, t, r], xs[:, j])
            if i != j:
                part[:, t, 1 + sl] = torch.einsum("brc,br->bc", Ap[:, t, r], xs[:, i, r])
    y = torch.empty_like(x).view(B, nt, tile)
    for s in range(nt):
        acc = torch.zeros((B, tile), dtype=Ap.dtype)
        for t, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
            if j == s and i < s:
                c = part[:, t, 1]
                for sl in range(1, slices):
                    c = c + part[:, t, 1 + sl]
                acc = acc + c
        for t, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
            if i == s:
                acc = acc + part[:, t, 0]
        y[:, s] = acc
    return y.view(B, n)


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_scratch_layout_gives_the_symmetric_matvec(slices):
    """The scratch the wrapper allocates, (B, T, 1 + S, tile), holds what
    pass 2 needs: every slot it reads is written (NaN elsewhere would
    show), and the sums give the plain version's y."""
    A, x = _sym_batch(B=2, n=384)
    Ap = symv.pack_symmetric(torch.from_numpy(A), 128)
    assert symv.scratch_shape(2, 6, slices, 128) == (2, 6, 1 + slices, 128)
    y = _two_pass(Ap, torch.from_numpy(x), 384, slices)
    assert _rel(y, symv.batched_symv_packed_reference(Ap, torch.from_numpy(x), 384)) < REL


@pytest.mark.parametrize("slices", [0, 3, 8, 128])
def test_wrappers_reject_bad_slices(slices):
    """A power of two, with slices of a multiple of 32 rows: at tile 128 at
    most 4."""
    A, x = _sym_batch(B=1, n=256)
    At, xt = torch.from_numpy(A), torch.from_numpy(x)
    Ap = symv.pack_symmetric(At, 128)
    for call in (lambda: symv.batched_symv(At, xt, 128, slices=slices),
                 lambda: symv.batched_symv_packed(Ap, xt, slices=slices),
                 lambda: symv.symv_packed(Ap[0], xt[0], slices=slices)):
        with pytest.raises(ValueError):
            call()
    # A valid count changes nothing on the CPU: the plain version.
    assert torch.equal(symv.symv_packed(Ap[0], xt[0], slices=2), symv.symv_packed(Ap[0], xt[0]))


def _sym_cuda(cuda, B, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    G = torch.randn((B, n, n), generator=gen, device=cuda)
    A = G + G.mT
    del G
    return A, torch.randn((B, n), generator=gen, device=cuda)


def _rel_cuda(y, ref):
    return float((y.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,tile", [(1, 512, 128), (1, 1024, 256), (1, 1024, 512),
                                      (3, 512, 256)])
def test_kernel_row_slices_on_cuda(cuda, B, n, tile):
    """Where few tiles leave the card idle, the kernel runs at more than one
    row slice: each entry point against its f64 plain version, two
    launches bitwise equal, at the picked S and at the most the tile takes
    (slices of 32 rows)."""
    A, x = _sym_cuda(cuda, B, n, B + n + tile)
    Ap = symv.pack_symmetric(A, tile)
    T = Ap.shape[1]
    S = symv.row_slices(B, T, tile, symv.sm_count(cuda.index))
    assert S > 1
    ref = symv.batched_symv_reference(A.double(), x.double(), tile)
    for slices in (None, tile // symv.SLICE_ROWS_STEP):
        for fn in (lambda: symv.batched_symv(A, x, tile, slices=slices),
                   lambda: symv.batched_symv_packed(Ap, x, slices=slices)):
            y = fn()
            assert _rel_cuda(y, ref) < 1e-5
            assert torch.equal(y.view(torch.int32), fn().view(torch.int32))
        y1 = symv.symv_packed(Ap[0], x[0], slices=slices)
        assert _rel_cuda(y1, ref[0]) < 1e-5
        assert torch.equal(y1.view(torch.int32),
                           symv.symv_packed(Ap[0], x[0], slices=slices).view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_picks_one_slice_at_full_batch_on_cuda(cuda):
    """At the packed mode's (2048, 1024, 256) the picked S is 1, and the
    output is bitwise that of a forced S = 1."""
    B, n, tile = 2048, 1024, 256
    A, x = _sym_cuda(cuda, B, n, 7)
    Ap = symv.pack_symmetric(A, tile)
    assert symv.row_slices(B, Ap.shape[1], tile, symv.sm_count(cuda.index)) == 1
    assert torch.equal(symv.batched_symv_packed(Ap, x).view(torch.int32),
                       symv.batched_symv_packed(Ap, x, slices=1).view(torch.int32))
    assert torch.equal(symv.batched_symv(A, x, tile).view(torch.int32),
                       symv.batched_symv(A, x, tile, slices=1).view(torch.int32))


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
