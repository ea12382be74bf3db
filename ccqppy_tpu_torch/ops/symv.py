"""Symmetric matvec ``y[b] = A[b] @ x[b]`` from the upper-triangle tiles of A.

Port of ``batched_symv``, ``batched_symv_packed``, ``symv_packed``,
``pack_symmetric`` and ``_upper_tile_tables`` from
``ccqppy_tpu/ops/pallas_kernels.py``.  A symmetric A is cut into
``tile x tile`` blocks; only the T = nt(nt+1)/2 blocks ``T_ij`` with
i <= j are read, each once, and

    y_i += T_ij x_j      and, for i < j,      y_j += T_ij^T x_i.

Two layouts: the full ``(B, n, n)`` stack, whose strictly-lower
off-diagonal tiles are never read (their content is ignored), and the
packed ``(B, T, tile, tile)`` stack from ``pack_symmetric`` (tiles in
row-major (i <= j) order), which also stores only those T tiles.  The
diagonal tiles are read whole, so their lower halves must mirror the upper.

On a CUDA tensor each wrapper launches the hand-written Hopper kernel
``csrc/batched_symv.cu`` (f32 only, tiles of 128, 256 or 512) or raises;
on a CPU tensor it computes its plain version in any floating dtype.
``symv_packed`` is the packed kernel at B = 1.  The kernel cuts each
tile's rows into ``slices`` blocks; ``row_slices`` picks how many from the
card's SM count, so that a single problem's few tiles still fill the card.
"""
from __future__ import annotations

import functools

import torch

from ccqppy_tpu_torch.ops import kernels

#: Number of kernel launches in this process, per wrapper.  Only a CUDA
#: launch adds to its wrapper's count; the plain versions on the CPU do not.
LAUNCHES = {"batched_symv": 0, "batched_symv_packed": 0, "symv_packed": 0}

#: Tile sizes the CUDA kernel is compiled for.
KERNEL_TILES = (128, 256, 512)
#: Rows of a slice are a multiple of this: the kernel's 8 warps, 4 rows in
#: flight each.
SLICE_ROWS_STEP = 32
#: Fewest rows of a tile one pass-1 block takes when ``row_slices`` picks.
#: Shorter slices cost more in column partials and pass-2 sums than their
#: extra blocks gain: on an H100 at B = 1, n = 1024, tile 256 (10 tiles) 4
#: slices of 64 rows took ~0.8x the time of one slice, 8 slices of 32 rows
#: ~0.9x (tools/symv_slices.py).
MIN_SLICE_ROWS = 64


def row_slices(batch, T, tile, sm_count):
    """Row slices S of each tile: the least power of two with
    ``batch * T * S >= sm_count`` pass-1 blocks (one an SM), but at most
    ``tile // MIN_SLICE_ROWS``.  S = 1 wherever ``batch * T`` blocks
    already fill the card."""
    S = 1
    while batch * T * S < sm_count and 2 * S * MIN_SLICE_ROWS <= tile:
        S *= 2
    return S


def scratch_shape(batch, T, slices, tile):
    """The kernel's scratch between its passes: per (problem, tile) slot 0
    holds the row partials, slot 1 + s slice s's column partial."""
    return (batch, T, 1 + slices, tile)


@functools.cache
def sm_count(index):
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def upper_tile_tables(nt):
    """(i, j) coordinates of the upper tiles, row-major: (0,0), (0,1), ...,
    (0,nt-1), (1,1), ..., (nt-1,nt-1).  Two int64 tensors of length T."""
    ii = [i for i in range(nt) for _ in range(i, nt)]
    jj = [j for i in range(nt) for j in range(i, nt)]
    return torch.tensor(ii, dtype=torch.int64), torch.tensor(jj, dtype=torch.int64)


def num_tiles(nt):
    return nt * (nt + 1) // 2


def pack_into(Ap, A, tile):
    """Copy the upper tiles of A (B, n, n) into Ap (B, T, tile, tile),
    T = num_tiles(ceil(n / tile)), tile by tile and without a padded copy
    of A.  The last tiles may overhang n by less than one tile; the
    overhang of Ap is left as it is (callers that pad pass a zeroed Ap)."""
    n = A.shape[-1]
    ii, jj = upper_tile_tables(-(-n // tile))
    for t, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        r0, c0 = i * tile, j * tile
        Ap[:, t, :min(tile, n - r0), :min(tile, n - c0)] = \
            A[:, r0:r0 + tile, c0:c0 + tile]
    return Ap


def pack_symmetric(A, tile=512):
    """Pack a symmetric stack (B, n, n), n % tile == 0, into its upper tiles
    (B, T, tile, tile), contiguous, in ``upper_tile_tables`` order."""
    B, n, n2 = A.shape
    if n != n2 or n % tile:
        raise ValueError(f"pack_symmetric takes (B, n, n) with n % tile == 0, "
                         f"got {tuple(A.shape)} and tile {tile}")
    nt = n // tile
    return pack_into(A.new_empty((B, num_tiles(nt), tile, tile)), A, tile)


def _symv_plain(tile_at, x, tile):
    """y = sum over upper tiles of T_ij x_j (+ T_ij^T x_i for i < j), in
    tile order; ``tile_at(t, i, j)`` is the (B, tile, tile) tile t."""
    B, n = x.shape
    nt = n // tile
    y = torch.zeros_like(x)
    ys, xs = y.view(B, nt, tile), x.view(B, nt, tile)
    ii, jj = upper_tile_tables(nt)
    for t, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        Tb = tile_at(t, i, j)
        ys[:, i] += torch.einsum("brc,bc->br", Tb, xs[:, j])
        if i != j:
            ys[:, j] += torch.einsum("brc,br->bc", Tb, xs[:, i])
    return y


def batched_symv_reference(Au, x, tile):
    """Plain version on the full (B, n, n) layout, in Au's dtype.  Reads
    only the upper tiles: the strictly-lower off-diagonal ones may hold
    anything."""
    x = x.to(Au.dtype).contiguous()
    return _symv_plain(
        lambda t, i, j: Au[:, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile],
        x, tile)


def batched_symv_packed_reference(Ap, x, n):
    """Plain version on the packed (B, T, tile, tile) layout, in Ap's dtype."""
    if x.shape[-1] != n:
        raise ValueError(f"x has {x.shape[-1]} entries, not n = {n}")
    x = x.to(Ap.dtype).contiguous()
    return _symv_plain(lambda t, i, j: Ap[:, t], x, Ap.shape[-1])


def symv_packed_reference(Ap, x, n):
    """Plain version of one problem: Ap (T, tile, tile), x (n,) -> (n,)."""
    return batched_symv_packed_reference(Ap[None], x[None], n)[0]


def check_kernel_inputs(A, x):
    """What the CUDA kernel takes: f32 A and x, contiguous, 16-byte aligned.
    Raises on anything else; the wrappers call it before every launch."""
    if A.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"the CUDA symv kernel takes float32 A and x, not "
                        f"{A.dtype} and {x.dtype}")
    if not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("the CUDA symv kernel takes contiguous A and x")
    if A.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("the CUDA symv kernel takes 16-byte aligned A and x")


def _check_device(A, x):
    if A.device != x.device:
        raise ValueError(f"A on {A.device} but x on {x.device}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"symv runs on cuda or cpu, not {A.device}")


def _check_slices(slices, tile):
    most = tile // SLICE_ROWS_STEP
    if slices is not None and (slices < 1 or slices > most or slices & (slices - 1)):
        raise ValueError(f"slices must be a power of two in [1, {most}] at tile {tile}, "
                         f"not {slices}")


def _launch(name, A, x, n, tile, packed, slices):
    """One launch of the kernel (both passes) on the current stream, counted
    as wrapper ``name``'s; ``slices`` None takes ``row_slices``' choice."""
    check_kernel_inputs(A, x)
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA symv kernel takes tiles {KERNEL_TILES}, not {tile}")
    B = x.shape[0]
    y = torch.empty((B, n), dtype=torch.float32, device=A.device)
    if B == 0:
        return y
    T = num_tiles(n // tile)
    if slices is None:
        slices = row_slices(B, T, tile, sm_count(A.device.index))
    part = torch.empty(scratch_shape(B, T, slices, tile), dtype=torch.float32, device=A.device)
    kernels.launch("batched_symv_packed_f32" if packed else "batched_symv_full_f32", A.device,
                   A.data_ptr(), x.data_ptr(), y.data_ptr(), part.data_ptr(), B, n, tile,
                   slices)
    LAUNCHES[name] += 1
    return y


def batched_symv(Au, x, tile=512, slices=None):
    """y[b] = A[b] @ x[b] for symmetric A given as a full (B, n, n) stack
    whose strictly-lower off-diagonal tiles are ignored; x (B, n);
    n % tile == 0.  Output in Au's dtype.  ``slices``: the kernel's row
    slices a tile (a power of two up to ``tile // SLICE_ROWS_STEP``; None:
    ``row_slices``'s pick)."""
    if Au.dim() != 3 or Au.shape[1] != Au.shape[2] or x.shape != Au.shape[:2]:
        raise ValueError(f"batched_symv takes Au (B, n, n) and x (B, n), got "
                         f"{tuple(Au.shape)} and {tuple(x.shape)}")
    n = Au.shape[-1]
    if n % tile:
        raise ValueError(f"n = {n} is not a multiple of tile = {tile}")
    _check_slices(slices, tile)
    _check_device(Au, x)
    if Au.device.type == "cpu":
        return batched_symv_reference(Au, x, tile)
    return _launch("batched_symv", Au, x, n, tile, False, slices)


def _check_packed(Ap, x, n):
    if Ap.dim() != 4 or Ap.shape[2] != Ap.shape[3]:
        raise ValueError(f"Ap must be (B, T, tile, tile), got {tuple(Ap.shape)}")
    B, T, tile, _ = Ap.shape
    if n is None:
        n = x.shape[-1]
    if x.shape != (B, n):
        raise ValueError(f"x must be (B, n) = {(B, n)}, got {tuple(x.shape)}")
    if n % tile:
        raise ValueError(f"n = {n} is not a multiple of tile = {tile}")
    if num_tiles(n // tile) != T:
        raise ValueError(f"n = {n} at tile {tile} has {num_tiles(n // tile)} "
                         f"upper tiles, Ap has {T}")
    _check_device(Ap, x)
    return n


def _symv_packed_batch(name, Ap, x, n, slices):
    n = _check_packed(Ap, x, n)
    _check_slices(slices, Ap.shape[-1])
    if Ap.device.type == "cpu":
        return batched_symv_packed_reference(Ap, x, n)
    return _launch(name, Ap, x, n, Ap.shape[-1], True, slices)


def batched_symv_packed(Ap, x, n=None, slices=None):
    """``batched_symv`` on the packed layout: Ap (B, T, tile, tile) from
    ``pack_symmetric``, x (B, n) -> (B, n) in Ap's dtype."""
    return _symv_packed_batch("batched_symv_packed", Ap, x, n, slices)


def symv_packed(Ap, x, n=None, slices=None):
    """One problem on the packed layout: Ap (T, tile, tile), x (n,) -> (n,)."""
    if Ap.dim() != 3 or x.dim() != 1:
        raise ValueError(f"symv_packed takes Ap (T, tile, tile) and x (n,), got "
                         f"{tuple(Ap.shape)} and {tuple(x.shape)}")
    return _symv_packed_batch("symv_packed", Ap[None], x[None], n, slices)[0]
