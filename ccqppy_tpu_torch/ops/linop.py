"""Linear operators for the QP Hessian ``A``, batched.

Port of the dense family of ``ccqppy_tpu/ops/linop.py``: the
``LinearOperator`` protocol, ``DenseOperator``, ``SymmetricPackedDense``
and ``as_operator``.  A dense operator holds a ``(B, n, n)`` stack;
``matvec`` maps ``(B, n)`` to ``(B, n)`` through ``ops.gemv.batched_gemv``
(the hand-written kernel on CUDA, exact fp32 FMA).  The packed symmetric
operator holds only the upper tiles and applies them through
``ops.symv.batched_symv_packed``.  ``dot`` and every other reduction is per
lane, over the last dimension; ``take(idx)`` restricts an operator to the
lanes ``idx``.

The JAX package's ``_gemv_fence`` (an XLA fusion barrier) has no
counterpart: PyTorch runs each operation as written.
"""
from __future__ import annotations

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


class DenseOperator(LinearOperator):
    """Dense stack A of shape (B, n, n); a single problem is B = 1."""

    def __init__(self, A):
        if A.dim() != 3 or A.shape[1] != A.shape[2]:
            raise ValueError(f"DenseOperator takes a (B, n, n) stack, got {tuple(A.shape)}")
        self.A = A

    def matvec(self, x):
        return batched_gemv(self.A, x)

    def inf_norm(self):
        return self.A.abs().sum(dim=-1).amax(dim=-1)

    def diagonal(self):
        return torch.diagonal(self.A, dim1=-2, dim2=-1)

    def take(self, idx):
        return DenseOperator(self.A[idx])


class SymmetricPackedDense(LinearOperator):
    """Symmetric operator stored as its upper tiles, batched: the matvec
    streams the T = nt(nt+1)/2 tiles once (the packed symv kernel on CUDA),
    about half the bytes and half the memory of a dense stack.

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


def as_operator(A):
    """Wrap a raw (B, n, n) tensor as a ``DenseOperator``; pass operators
    through."""
    if isinstance(A, LinearOperator):
        return A
    return DenseOperator(A)
