"""Linear operators for the QP Hessian ``A``, batched.

Port of the single-device operators of ``ccqppy_tpu/ops/linop.py``: the
``LinearOperator`` protocol, ``DenseOperator``, ``FastDense``,
``BlockSparseOperator``, ``CastDense``, ``MixedPrecDense``,
``SymmetricPackedDense``, ``SpectralDense`` with
``estimate_spectral_bounds``, and ``as_operator``.
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
import torch.nn.functional as F

from ccqppy_tpu_torch.ops import symv
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
        if blocks.dim() != 5 or blocks.shape[3] != blocks.shape[4]:
            raise ValueError(f"blocks must be (B, nbr, k_max, bs, bs), got {tuple(blocks.shape)}")
        if blocks.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"BlockSparseOperator takes float32 or float64 blocks, "
                            f"not {blocks.dtype}")
        if cols.shape != blocks.shape[:3] or cols.dtype != torch.int64:
            raise TypeError(f"cols must be int64 of shape {tuple(blocks.shape[:3])}, got "
                            f"{cols.dtype} {tuple(cols.shape)}")
        if cols.device != blocks.device:
            raise ValueError(f"blocks on {blocks.device} but cols on {cols.device}")
        B, nbr, _, bs, _ = blocks.shape
        self.blocks, self.cols, self.n = blocks, cols, int(nbr * bs)
        # The rows of x's blocks in a flat (B * nbr, bs) view of x.
        lane = torch.arange(B, dtype=torch.int64, device=cols.device)
        self._rows = (cols + nbr * lane[:, None, None]).reshape(-1)

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
        B, nbr, kmax, bs, _ = self.blocks.shape
        acc = torch.promote_types(self.blocks.dtype, x.dtype)
        xb = x.reshape(B * nbr, bs).to(acc).index_select(0, self._rows)
        prod = (self.blocks.to(acc) * xb.view(B, nbr, kmax, 1, bs)).sum(dim=-1)
        return prod.sum(dim=2).reshape(B, self.n)

    def inf_norm(self):
        return self.blocks.abs().sum(dim=(2, 4)).amax(dim=(1, 2))

    def diagonal(self):
        B, nbr, _, bs, _ = self.blocks.shape
        rows = torch.arange(nbr, dtype=self.cols.dtype, device=self.cols.device)
        on_diag = (self.cols == rows[None, :, None]).to(self.blocks.dtype)
        diag_blocks = (self.blocks * on_diag[..., None, None]).sum(dim=2)
        return torch.diagonal(diag_blocks, dim1=-2, dim2=-1).reshape(B, self.n)

    def take(self, idx):
        return BlockSparseOperator(self.blocks[idx], self.cols[idx])


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


def power_spectral_bounds(matvec, v0, iters=32, safety=0.02):
    """Per-lane ``(L, mu)``, each ``(B,)``, of the operator ``matvec`` by
    power iteration from ``v0`` (B, n): lambda_max of A, then of ``c I - A``
    with ``c = 1.01 L`` (whose top eigenvalue is c - lambda_min), each
    after ``iters`` iterations and widened by ``safety``:
    ``L = (1 + safety) est``, ``mu = (1 - safety) est``.  2 (iters + 1)
    matvecs."""
    tiny = torch.finfo(v0.dtype).tiny

    def lam_max(shift):
        def apply(v):
            Av = matvec(v)
            return torch.where(shift[:, None] > 0, shift[:, None] * v - Av, Av)

        v = v0
        for _ in range(int(iters)):
            w = apply(v)
            v = w / (torch.sqrt((w * w).sum(-1, keepdim=True)) + tiny)
        return (v * apply(v)).sum(-1)

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
