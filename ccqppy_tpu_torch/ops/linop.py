"""Linear operators for the QP Hessian ``A``, batched.

Port of the single-device operators of ``ccqppy_tpu/ops/linop.py``: the
``LinearOperator`` protocol, ``DenseOperator``, ``FastDense``,
``BlockSparseOperator``, ``CastDense``, ``MixedPrecDense``,
``SymmetricPackedDense``, ``SpectralDense`` with
``estimate_spectral_bounds``, and ``as_operator``; and of the row-sharded
operators ``ShardedDenseOperator`` and ``ShardedBlockSparseOperator``, whose
collectives are ``torch.distributed`` calls (``ops.collectives``).
A dense operator holds a ``(B, n, n)`` stack;
``matvec`` maps ``(B, n)`` to ``(B, n)`` through ``ops.gemv.batched_gemv``
(the hand-written kernel on CUDA, exact fp32 or f64 FMA; for a bf16 stack
the kernel's bf16 instance, which rounds x to bf16).  The packed symmetric
operator holds only the upper tiles and applies them through
``ops.symv.batched_symv_packed``.  The block-sparse operator's matvec is
plain PyTorch.  ``dot`` and every other reduction is per
lane, over the last dimension; ``take(idx)`` restricts an operator to the
lanes ``idx``.

The JAX package's ``_gemv_fence`` (an XLA fusion barrier) has no
counterpart: PyTorch runs each operation as written.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ccqppy_tpu_torch.ops import collectives, symv
from ccqppy_tpu_torch.ops.gemv import batched_gemv


class LinearOperator:
    """Protocol: batch of symmetric positive (semi)definite operators."""

    def matvec(self, x):
        raise NotImplementedError

    def dot(self, u, v):
        """Per-lane inner product: (B, n), (B, n) -> (B,)."""
        return (u * v).sum(dim=-1)

    def norm(self, u):
        return torch.sqrt(self.dot(u, u))

    def inf_norm(self):
        """Per-lane ||A||_inf."""
        raise NotImplementedError

    def global_size(self, x):
        """Logical problem dimension n given an iterate."""
        return x.shape[-1]

    def reduce_min(self, v):
        """Global min of a per-shard value (identity off-mesh)."""
        return v

    def diagonal(self):
        """diag(A) per lane, used for Jacobi preconditioning."""
        raise NotImplementedError

    def matvec_exact(self, x):
        """Full-precision matvec; ``matvec`` itself for exact operators."""
        return self.matvec(x)

    def matvec_f64(self, x):
        """``A x`` with f64 sums over the operator's own entries, whatever
        x's dtype: the exact matvec of x widened to f64 (on an f32 dense
        stack, the GEMV kernel's (f32 A, f64 x) instance).  The audit of an
        iterate that carries less precision than its check."""
        return self.matvec_exact(x.to(torch.float64))

    def spectral_bounds(self):
        """(L, mu) with L >= lambda_max(A); mu unknown by default."""
        return self.inf_norm(), None

    def take(self, idx):
        """The operator restricted to lanes ``idx`` (a 1-D index tensor)."""
        raise NotImplementedError


def _check_stack(cls, A, dtypes):
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{cls} takes a (B, n, n) stack, got {tuple(A.shape)}")
    if A.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        hint = " (a bfloat16 stack is a CastDense)" if A.dtype == torch.bfloat16 else ""
        raise TypeError(f"{cls} takes a {names} stack, not {A.dtype}{hint}")


def _check_ell(cls, blocks, cols):
    if blocks.dim() != 5 or blocks.shape[3] != blocks.shape[4]:
        raise ValueError(f"blocks must be (B, nbr, k_max, bs, bs), got {tuple(blocks.shape)}")
    if blocks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{cls} takes float32 or float64 blocks, not {blocks.dtype}")
    if cols.shape != blocks.shape[:3] or cols.dtype != torch.int64:
        raise TypeError(f"cols must be int64 of shape {tuple(blocks.shape[:3])}, got "
                        f"{cols.dtype} {tuple(cols.shape)}")
    if cols.device != blocks.device:
        raise ValueError(f"blocks on {blocks.device} but cols on {cols.device}")


def _ell_rows(cols, nbr_x):
    """The rows of x's blocks in a flat (B * nbr_x, bs) view of an x (B, n)
    with ``nbr_x`` block rows, one for each (lane, block row, slot)."""
    lane = torch.arange(cols.shape[0], dtype=torch.int64, device=cols.device)
    return (cols + nbr_x * lane[:, None, None]).reshape(-1)


def _ell_matvec(blocks, rows, x):
    """Per lane, each block row's ``k_max`` blocks times the blocks of x they
    point at (``rows``, from ``_ell_rows``), summed over the slots: (B,
    nbr * bs) in ``promote(blocks, x)``.  An elementwise product and sums
    over the last axis, so every product is exact in the sums' dtype."""
    B, nbr, kmax, bs, _ = blocks.shape
    acc = torch.promote_types(blocks.dtype, x.dtype)
    xb = x.reshape(-1, bs).to(acc).index_select(0, rows)
    prod = (blocks.to(acc) * xb.view(B, nbr, kmax, 1, bs)).sum(dim=-1)
    return prod.sum(dim=2).reshape(B, nbr * bs)


def _ell_diagonal(blocks, cols, first_row):
    """diag(A) on the block rows held, the first of which is global block
    row ``first_row``: per block row, the diagonal of its blocks whose
    column is the row's own."""
    B, nbr, _, bs, _ = blocks.shape
    rows = first_row + torch.arange(nbr, dtype=cols.dtype, device=cols.device)
    on_diag = (cols == rows[None, :, None]).to(blocks.dtype)
    diag_blocks = (blocks * on_diag[..., None, None]).sum(dim=2)
    return torch.diagonal(diag_blocks, dim1=-2, dim2=-1).reshape(B, nbr * bs)


class DenseOperator(LinearOperator):
    """Dense f32 or f64 stack A of shape (B, n, n); a single problem is
    B = 1.  The matvec keeps x's precision (``promote(A, x)``); a bfloat16
    stack, whose matvec rounds x, is a ``CastDense``."""

    def __init__(self, A):
        _check_stack(type(self).__name__, A, (torch.float32, torch.float64))
        self.A = A

    def matvec(self, x):
        return batched_gemv(self.A, x)

    def inf_norm(self):
        return self.A.abs().sum(dim=-1).amax(dim=-1)

    def diagonal(self):
        return torch.diagonal(self.A, dim1=-2, dim2=-1)

    def take(self, idx):
        return DenseOperator(self.A[idx])


class FastDense(DenseOperator):
    """The JAX package's cheap-sweep operator, kept so that configurations
    carry over: there ``matvec`` is a DEFAULT-precision sweep (bf16-grade
    MXU products) and ``matvec_exact`` a HIGHEST one over the same f32
    buffer.  The H100's f32 GEMV kernel has no such split: it does exact
    fp32 FMA bound by memory, and TF32 stays off, since the convergence
    decisions rest on exact sweeps.  So ``matvec`` and ``matvec_exact`` are
    the same f32 kernel sweep, and rr-PCG on a ``FastDense`` computes what it
    computes on a ``DenseOperator``."""

    def take(self, idx):
        return FastDense(self.A[idx])


class BlockSparseOperator(LinearOperator):
    """Block-sparse symmetric operator in ELL layout, batched: every
    block-row holds ``k_max`` dense ``bs x bs`` blocks, a shorter row padded
    with zero blocks pointing at block-column 0 (a zero block adds nothing,
    so any column is safe).  A single problem is B = 1.

    Fields:
      blocks: (B, nbr, k_max, bs, bs) float32 or float64 blocks.
      cols:   (B, nbr, k_max) int64 block-column ids.
      n:      logical dimension nbr * bs.

    The matvec gathers x's blocks and sums the products over each block's
    columns, then over k_max, in plain PyTorch: an elementwise product and a
    sum over the last axis, so every product is exact in the sums' dtype
    whatever the TF32 flags say.  The JAX package computes it with an XLA
    gather and einsum, no Pallas kernel.  Build with ``from_scipy_bsr`` or
    ``from_dense_blocks``.
    """

    def __init__(self, blocks, cols):
        _check_ell("BlockSparseOperator", blocks, cols)
        B, nbr, _, bs, _ = blocks.shape
        self.blocks, self.cols, self.n = blocks, cols, int(nbr * bs)
        self._rows = _ell_rows(cols, nbr)

    @staticmethod
    def from_dense_blocks(blocks, cols):
        """From ELL arrays: ``blocks (nbr, k_max, bs, bs)`` and ``cols
        (nbr, k_max)`` of one problem, or both with a leading lane axis."""
        if blocks.dim() == 4:
            blocks, cols = blocks[None], cols[None]
        return BlockSparseOperator(blocks.contiguous(), cols.to(torch.int64).contiguous())

    @staticmethod
    def from_scipy_bsr(mat, dtype=torch.float32, device=None):
        """One problem (B = 1) from a ``scipy.sparse.bsr_matrix`` (or any
        matrix scipy converts to one), with the JAX builder's blocks and
        cols.  Vectorised: the slot of stored block i in its row is
        ``i - indptr[row(i)]``."""
        import scipy.sparse as sp

        bsr = mat if sp.issparse(mat) and mat.format == "bsr" else sp.bsr_matrix(mat)
        bs = bsr.blocksize[0]
        if bsr.blocksize[0] != bsr.blocksize[1]:
            raise ValueError("square blocks required")
        nbr = bsr.shape[0] // bs
        counts = np.diff(bsr.indptr)
        nnzb = int(bsr.indptr[-1])
        kmax = max(int(counts.max(initial=0)), 1)
        row = np.repeat(np.arange(nbr), counts)
        slot = np.arange(nnzb) - np.repeat(bsr.indptr[:-1], counts)
        blocks = np.zeros((nbr, kmax, bs, bs), np.asarray(bsr.data).dtype)
        cols = np.zeros((nbr, kmax), np.int64)
        blocks[row, slot] = bsr.data[:nnzb]
        cols[row, slot] = bsr.indices[:nnzb]
        return BlockSparseOperator(torch.as_tensor(blocks[None], dtype=dtype, device=device),
                                   torch.as_tensor(cols[None], device=device))

    def matvec(self, x):
        return _ell_matvec(self.blocks, self._rows, x)

    def inf_norm(self):
        return self.blocks.abs().sum(dim=(2, 4)).amax(dim=(1, 2))

    def diagonal(self):
        return _ell_diagonal(self.blocks, self.cols, 0)

    def take(self, idx):
        return BlockSparseOperator(self.blocks[idx], self.cols[idx])


class _RowSharded(LinearOperator):
    """The reductions of a row-sharded operator: this rank holds rows
    [rank * n_local, (rank + 1) * n_local) of every lane's A and the solver
    carries the matching rows of x (B, n_local).  Dots and norms sum their
    per-rank partials over the process group ``group`` (all_reduce SUM),
    the feasible-step minimum takes MIN, ``inf_norm`` MAX, so every rank
    gets the same values and the unchanged solvers run distributed.
    ``group`` None is the default process group."""

    def __init__(self, group):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def dot(self, u, v):
        return collectives.all_reduce((u * v).sum(dim=-1), "sum", self.group)

    def reduce_min(self, v):
        return collectives.all_reduce(v.clone(), "min", self.group)

    def global_size(self, x):
        return x.shape[-1] * self.world

    def _gather(self, x_local):
        return collectives.all_gather_last(x_local, self.group)


class ShardedDenseOperator(_RowSharded):
    """Row-block-sharded dense operator: this rank's rows ``A_local (B,
    n_local, n)`` of a (B, n, n) stack whose rows are split in equal
    contiguous blocks over the ranks of ``group``, in rank order (what
    ``parallel.sharded.solve_sharded`` makes).

    ``matvec`` all-gathers x along its last axis (one collective) and
    multiplies the local rows by it (``local_matvec``).  The JAX package
    computes that product with an XLA dot at HIGHEST precision, not a
    Pallas kernel; here it is ``torch.matmul``, which on CUDA needs TF32
    off (PyTorch's default) so that f32 products stay IEEE: with
    ``torch.backends.cuda.matmul.allow_tf32`` on, the f32 matvec raises.

    The projection must be separable (box, bounds, identity) or blockwise
    with blocks that do not cross a shard boundary: a set over all of x
    (a ball, a cone spanning shards) would need collectives of its own.
    """

    def __init__(self, A_local, group=None):
        if A_local.dim() != 3:
            raise ValueError(f"A_local must be (B, n_local, n), got {tuple(A_local.shape)}")
        if A_local.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"ShardedDenseOperator takes float32 or float64 rows, "
                            f"not {A_local.dtype}")
        super().__init__(group)
        self.A_local = A_local

    def local_matvec(self, x_full):
        """This rank's rows of A x, from the whole x (B, n)."""
        acc = torch.promote_types(self.A_local.dtype, x_full.dtype)
        if self.A_local.is_cuda and acc == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("ShardedDenseOperator needs IEEE f32 products: set "
                               "torch.backends.cuda.matmul.allow_tf32 = False")
        return torch.matmul(self.A_local.to(acc), x_full.to(acc).unsqueeze(-1)).squeeze(-1)

    def matvec(self, x_local):
        return self.local_matvec(self._gather(x_local))

    def inf_norm(self):
        local = self.A_local.abs().sum(dim=-1).amax(dim=-1)
        return collectives.all_reduce(local, "max", self.group)

    def diagonal(self):
        """This rank's rows of diag(A): local row i is global row
        ``rank * n_local + i``.  The offset holds only for equal contiguous
        row blocks in rank order; any other layout raises here or would
        pick off-diagonal entries."""
        _, n_local, n = self.A_local.shape
        if n_local * self.world != n:
            raise ValueError(f"ShardedDenseOperator.diagonal requires equal contiguous row "
                             f"blocks: n_local={n_local} * world={self.world} != n={n}")
        i = torch.arange(n_local, device=self.A_local.device)
        return self.A_local[:, i, self.rank * n_local + i]


class ShardedBlockSparseOperator(_RowSharded):
    """Row-block-sharded block-sparse (ELL) operator: the one huge QP of
    ``BlockSparseOperator`` split over the ranks of ``group``.

    Fields (this rank's share, B lanes):
      blocks: (B, nbr_local, k_max, bs, bs) its block rows, in rank order.
      cols:   (B, nbr_local, k_max) int64 GLOBAL block-column ids.
      n:      the global dimension.

    ``matvec`` all-gathers x (one collective a sweep, the dense sharded
    path's pattern) and applies the local block rows to the whole x with
    ``BlockSparseOperator``'s gather and sums, in plain PyTorch as the JAX
    package's XLA einsum.  Reductions as in ``ShardedDenseOperator``.
    """

    def __init__(self, blocks, cols, n, group=None):
        _check_ell("ShardedBlockSparseOperator", blocks, cols)
        super().__init__(group)
        self.blocks, self.cols, self.n = blocks, cols, int(n)
        bs = blocks.shape[3]
        if self.n % bs:
            raise ValueError(f"n={self.n} is not a whole number of {bs}-blocks")
        self._rows = _ell_rows(cols, self.n // bs)

    def matvec(self, x_local):
        return _ell_matvec(self.blocks, self._rows, self._gather(x_local))

    def inf_norm(self):
        local = self.blocks.abs().sum(dim=(2, 4)).amax(dim=(1, 2))
        return collectives.all_reduce(local, "max", self.group)

    def diagonal(self):
        """This rank's rows of diag(A): it holds global block rows
        [rank * nbr_local, (rank + 1) * nbr_local).  As in
        ``ShardedDenseOperator.diagonal``, equal contiguous block-row shards
        in rank order only."""
        nbr, bs = self.blocks.shape[1], self.blocks.shape[3]
        if nbr * self.world * bs != self.n:
            raise ValueError(f"ShardedBlockSparseOperator.diagonal requires equal contiguous "
                             f"block-row shards: nbr_local={nbr} * world={self.world} * "
                             f"bs={bs} != n={self.n}")
        return _ell_diagonal(self.blocks, self.cols, self.rank * nbr)


class CastDense(LinearOperator):
    """Dense stack stored in bfloat16, applied to a bf16 rounding of x with
    sums in ``promote(x.dtype, float32)``: the cheap rung of the
    mixed-precision ladder (``parallel/mixed.py``).  On CUDA the matvec is
    the GEMV kernel's bf16 instance (fp32 FMA on bf16 products, half the
    bytes of an f32 sweep); x is then float32.  Solutions against this
    operator carry a true-residual floor of roughly ``2^-8 ||A||``, and the
    solver's own residual floors near it too (each sweep rounds x to bf16),
    so a full-precision phase must follow."""

    def __init__(self, A):
        _check_stack("CastDense", A, (torch.bfloat16,))
        self.A = A

    @staticmethod
    def from_f32(A, dtype=torch.bfloat16):
        return CastDense(A.to(dtype))

    def matvec(self, x):
        return batched_gemv(self.A, x).to(x.dtype)

    def inf_norm(self):
        return self.A.abs().sum(dim=-1, dtype=torch.float32).amax(dim=-1)

    def diagonal(self):
        return torch.diagonal(self.A, dim1=-2, dim2=-1).float()

    def take(self, idx):
        return CastDense(self.A[idx])


class MixedPrecDense(LinearOperator):
    """Dense operator carrying two precisions: ``matvec`` streams the low
    copy ``A_low``, ``matvec_exact`` the full ``A``.  The operand of
    residual-replacement PCG (``models.pcg`` with ``refresh_every > 0``):
    the CG recurrence rides the cheap sweeps, every refresh and reported
    residual the exact one.  Two pairs (A, A_low):

    * (float32, bfloat16), the bf16 -> f32 ladder: the cheap sweep is
      ``CastDense``'s (x rounded to bf16, sums in
      ``promote(x.dtype, float32)``).  Build with ``from_f32(A)`` or from
      ``parallel.prepare_dense_batch(As, torch.bfloat16)``.
    * (float64, float32), the f64-exact rung: the cheap sweep is the f32
      GEMV of x rounded to f32, summed in f32 whatever x's dtype, and cast
      back to x's dtype (the JAX package's choice: an f32 sweep, not an f64
      one); the exact sweep is the GEMV kernel's f64 instance.
    """

    PAIRS = {torch.float32: torch.bfloat16, torch.float64: torch.float32}

    def __init__(self, A, A_low):
        _check_stack("MixedPrecDense", A, tuple(self.PAIRS))
        if A_low.dtype != self.PAIRS[A.dtype]:
            raise TypeError(f"MixedPrecDense pairs a {A.dtype} A with a "
                            f"{self.PAIRS[A.dtype]} A_low, not {A_low.dtype}")
        if A_low.shape != A.shape:
            raise ValueError(f"A_low {tuple(A_low.shape)} must match A {tuple(A.shape)}")
        self.A, self.A_low = A, A_low

    @staticmethod
    def from_f32(A, dtype=torch.bfloat16):
        return MixedPrecDense(A, A.to(dtype))

    def matvec(self, x):
        # The deliberately cheap sweep: its accuracy is that of A_low.
        if self.A.dtype == torch.float64:
            return batched_gemv(self.A_low, x.to(self.A_low.dtype)).to(x.dtype)
        return batched_gemv(self.A_low, x).to(x.dtype)

    def matvec_exact(self, x):
        return batched_gemv(self.A, x)

    def inf_norm(self):
        return self.A.abs().sum(dim=-1).amax(dim=-1)

    def diagonal(self):
        return torch.diagonal(self.A, dim1=-2, dim2=-1)

    def take(self, idx):
        return MixedPrecDense(self.A[idx], self.A_low[idx])


class SymmetricPackedDense(LinearOperator):
    """Symmetric operator stored as its upper tiles, batched: the matvec
    streams the T = nt(nt+1)/2 tiles once (the packed symv kernel on CUDA),
    about half the bytes and half the memory of a dense stack.  At B = 1
    the matvec is ``symv.symv_packed``, the single-problem wrapper.

    Fields:
      Ap:    (B, T, tile, tile) upper tiles in ``symv.upper_tile_tables``
             order; n is padded up to a multiple of ``tile`` with zeros.
      diag:  (B, n) true diagonal (Jacobi preconditioning).
      n:     logical dimension.
      tile:  tile size (128, 256 or 512 for the CUDA kernel).

    Build with ``SymmetricPackedDense.from_dense(A, tile)``.
    """

    def __init__(self, Ap, diag, n, tile):
        if Ap.dim() != 4 or Ap.shape[2:] != (tile, tile):
            raise ValueError(f"Ap must be (B, T, {tile}, {tile}), got {tuple(Ap.shape)}")
        if diag.shape != (Ap.shape[0], n):
            raise ValueError(f"diag must be {(Ap.shape[0], n)}, got {tuple(diag.shape)}")
        self.npad = -(-n // tile) * tile
        if symv.num_tiles(self.npad // tile) != Ap.shape[1]:
            raise ValueError(f"n = {n} at tile {tile} needs "
                             f"{symv.num_tiles(self.npad // tile)} tiles, Ap has {Ap.shape[1]}")
        self.Ap, self.diag, self.n, self.tile = Ap, diag, int(n), int(tile)

    @staticmethod
    def from_dense(A, tile=256):
        """Pack a symmetric (B, n, n) stack.  The tiles are copied one by one
        from A into a zeroed (B, T, tile, tile) buffer, so no padded copy of A
        is made: peak memory is A plus the packed stack."""
        if A.dim() != 3 or A.shape[1] != A.shape[2]:
            raise ValueError(f"from_dense takes a (B, n, n) stack, got {tuple(A.shape)}")
        B, n, _ = A.shape
        nt = -(-n // tile)
        Ap = symv.pack_into(A.new_zeros((B, symv.num_tiles(nt), tile, tile)), A, tile)
        return SymmetricPackedDense(Ap, A.diagonal(dim1=-2, dim2=-1).clone(), n, tile)

    def matvec(self, x):
        xp = F.pad(x, (0, self.npad - self.n)) if self.npad != self.n else x.contiguous()
        if self.Ap.shape[0] == 1:
            # One problem: the single-problem kernel, as the JAX operator of
            # one problem applies it.
            y = symv.symv_packed(self.Ap[0], xp[0], n=self.npad)[None]
        else:
            y = symv.batched_symv_packed(self.Ap, xp, n=self.npad)
        return y[:, :self.n] if self.npad != self.n else y

    def inf_norm(self):
        # ||A||_inf = max_i sum_j |A_ij|: row block i gets the row sums of
        # its tiles (i, j) and the column sums of the tiles (k, i) above the
        # diagonal.  Padding rows are zero and cannot win the max.
        B, T, tile, _ = self.Ap.shape
        nt = self.npad // tile
        ii, jj = (t.to(self.Ap.device) for t in symv.upper_tile_tables(nt))
        absA = self.Ap.abs()
        rows = torch.zeros((B, nt, tile), dtype=self.Ap.dtype, device=self.Ap.device)
        rows.index_add_(1, ii, absA.sum(dim=-1))
        off = ii != jj
        rows.index_add_(1, jj[off], absA.sum(dim=-2)[:, off])
        return rows.amax(dim=(1, 2))

    def diagonal(self):
        return self.diag

    def take(self, idx):
        return SymmetricPackedDense(self.Ap[idx], self.diag[idx], self.n, self.tile)


class SpectralDense(DenseOperator):
    """Dense stack carrying per-lane spectral bounds: ``L (B,)`` with
    L >= lambda_max sets the step 1/L of ``apgd.solve_sc``, ``mu (B,)``
    with mu <= lambda_min its constant momentum.  Build the bounds once per
    fixed ensemble with ``estimate_spectral_bounds``."""

    def __init__(self, A, L, mu):
        super().__init__(A)
        if L.shape != A.shape[:1] or mu.shape != A.shape[:1]:
            raise ValueError(f"L and mu must be ({A.shape[0]},), got "
                             f"{tuple(L.shape)} and {tuple(mu.shape)}")
        self.L, self.mu = L, mu

    def spectral_bounds(self):
        return self.L, self.mu

    def take(self, idx):
        return SpectralDense(self.A[idx], self.L[idx], self.mu[idx])


def power_spectral_bounds(matvec, v0, iters=32, safety=0.02, dot=None):
    """Per-lane ``(L, mu)``, each ``(B,)``, of the operator ``matvec`` by
    power iteration from ``v0`` (B, n): lambda_max of A, then of ``c I - A``
    with ``c = 1.01 L`` (whose top eigenvalue is c - lambda_min), each
    after ``iters`` iterations and widened by ``safety``:
    ``L = (1 + safety) est``, ``mu = (1 - safety) est``.  2 (iters + 1)
    matvecs.  ``dot`` is the operator's inner product (a sharded
    operator's sums over its ranks); None is the per-lane dot."""
    tiny = torch.finfo(v0.dtype).tiny
    if dot is None:
        dot = LinearOperator().dot

    def lam_max(shift):
        def apply(v):
            Av = matvec(v)
            return torch.where(shift[:, None] > 0, shift[:, None] * v - Av, Av)

        v = v0
        for _ in range(int(iters)):
            w = apply(v)
            v = w / (torch.sqrt(dot(w, w))[:, None] + tiny)
        return dot(v, apply(v))

    L = (1.0 + safety) * lam_max(torch.zeros_like(v0[:, 0]))
    shift = L * 1.01
    return L, torch.clamp((1.0 - safety) * (shift - lam_max(shift)), min=0.0)


def estimate_spectral_bounds(As, iters=32, safety=0.02):
    """Per-lane ``(L, mu)``, each ``(B,)``, for a stacked SPD batch
    ``(B, n, n)``: ``power_spectral_bounds`` from the unit vector of ones,
    every matvec through ``batched_gemv``.  This is the JAX package's
    algorithm unchanged: it does not certify the bounds (ROADMAP queue 3).
    """
    B, n, _ = As.shape
    v0 = torch.ones((B, n), dtype=As.dtype, device=As.device) / \
        torch.sqrt(torch.tensor(n, dtype=As.dtype))
    return power_spectral_bounds(lambda v: batched_gemv(As, v), v0, iters, safety)


def as_operator(A):
    """Wrap a raw (B, n, n) tensor as a ``DenseOperator``; pass operators
    through."""
    if isinstance(A, LinearOperator):
        return A
    return DenseOperator(A)
