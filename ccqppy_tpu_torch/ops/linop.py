"""Linear operators for the QP Hessian ``A``, batched.

Port of the dense family of ``ccqppy_tpu/ops/linop.py``: the
``LinearOperator`` protocol, ``DenseOperator`` and ``as_operator``.  A
dense operator holds a ``(B, n, n)`` stack; ``matvec`` maps ``(B, n)`` to
``(B, n)`` through ``ops.gemv.batched_gemv`` (the hand-written kernel on
CUDA, exact fp32 FMA).  ``dot`` and every other reduction is per lane,
over the last dimension.

The JAX package's ``_gemv_fence`` (an XLA fusion barrier) has no
counterpart: PyTorch runs each operation as written.
"""
from __future__ import annotations

import torch

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


def as_operator(A):
    """Wrap a raw (B, n, n) tensor as a ``DenseOperator``; pass operators
    through."""
    if isinstance(A, LinearOperator):
        return A
    return DenseOperator(A)
