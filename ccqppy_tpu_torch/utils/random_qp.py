"""Random convex-QP ensembles, generated where the generator lives.

Port of ``ccqppy_tpu/utils/random_qp.py``: Hessian ``A = G G^T`` (a
Wishart(n, I) draw, ``G`` an n x n standard normal) plus ``diag_boost * n * I``,
unconstrained optimum ``x ~ U(-1, 1)^n`` and ``b = -A x``.  Randomness comes
from an explicit ``torch.Generator``, and the tensors are made on that
generator's device.  A ``torch.Generator`` and ``jax.random`` give different
numbers from the same seed: the distribution is the same, the draws are not.
``block_tridiag_qp`` is the huge block-sparse QP of
``benchmarks/benchmark_huge_qp.py``, drawn from numpy as there.
"""
from __future__ import annotations

import numpy as np
import torch

from ccqppy_tpu_torch.ops.linop import BlockSparseOperator


def random_qp_batch(generator, batch, n, dtype=torch.float32, diag_boost=0.0,
                    chunk=None):
    """Batch of independent random QPs: A (B, n, n), b (B, n), x_uncon (B, n).

    ``chunk`` generates the batch in pieces of that many lanes, written into
    the preallocated output, to cap the transient of the factor G (which
    would otherwise double the footprint of A).  Defaults to the whole batch
    below 256, else 256.
    """
    device = generator.device
    if chunk is None:
        chunk = batch if batch <= 256 else 256
    A = torch.empty((batch, n, n), dtype=dtype, device=device)
    b = torch.empty((batch, n), dtype=dtype, device=device)
    x = torch.empty((batch, n), dtype=dtype, device=device)
    for i in range(0, batch, chunk):
        c = min(chunk, batch - i)
        G = torch.randn((c, n, n), generator=generator, dtype=dtype, device=device)
        torch.bmm(G, G.transpose(1, 2), out=A[i:i + c])
        del G
        if diag_boost:
            A[i:i + c].diagonal(dim1=-2, dim2=-1).add_(diag_boost * n)
        x[i:i + c] = 2 * torch.rand((c, n), generator=generator, dtype=dtype,
                                    device=device) - 1
        b[i:i + c] = -torch.bmm(A[i:i + c], x[i:i + c, :, None])[..., 0]
    return A, b, x


def random_qp(generator, n, dtype=torch.float32, diag_boost=0.0):
    """One random QP as a batch of one: A (1, n, n), b (1, n), x (1, n)."""
    return random_qp_batch(generator, 1, n, dtype, diag_boost)


BLOCK_TRIDIAG_BS = 4   # block size
BLOCK_TRIDIAG_K = 3    # blocks per block-row


def block_tridiag_qp(n, seed=0, dtype=torch.float32, device=None):
    """The huge-QP problem of ``benchmarks/benchmark_huge_qp.py``
    (``build_block_tridiag``), as one problem (B = 1): an SPD
    block-tridiagonal ``BlockSparseOperator`` of 4 x 4 blocks, 3 a
    block-row, built directly in ELL layout, with ``x_exact ~ U(-0.5, 0.5)``
    and ``b = -A x_exact``.  The draws are numpy's ``default_rng(seed)`` in
    the same order, so the blocks and ``x_exact`` are the JAX script's own;
    ``b`` is computed on ``device``.  Returns (op, b (1, n), x_exact (1, n)).
    """
    bs, k = BLOCK_TRIDIAG_BS, BLOCK_TRIDIAG_K
    nbr = n // bs
    rng = np.random.default_rng(seed)
    # Off-diagonal block B_i couples block-rows i and i + 1.
    off = (0.35 * rng.standard_normal((nbr - 1, bs, bs))).astype(np.float32)
    diag = 0.35 * rng.standard_normal((nbr, bs, bs)).astype(np.float32)
    # Row-sum dominance keeps A SPD with a condition of ~1e2.
    diag = 0.5 * (diag + diag.transpose(0, 2, 1)) + 3.0 * np.eye(bs, dtype=np.float32)
    blocks = np.zeros((nbr, k, bs, bs), np.float32)
    cols = np.zeros((nbr, k), np.int64)
    # Slot 0: left neighbour (the transpose of its off block), slot 1: the
    # diagonal, slot 2: right neighbour; edge rows pad with zero blocks at 0.
    blocks[1:, 0] = off.transpose(0, 2, 1)
    cols[1:, 0] = np.arange(nbr - 1)
    blocks[:, 1] = diag
    cols[:, 1] = np.arange(nbr)
    blocks[:-1, 2] = off
    cols[:-1, 2] = np.arange(1, nbr)
    op = BlockSparseOperator.from_dense_blocks(
        torch.as_tensor(blocks, dtype=dtype, device=device),
        torch.as_tensor(cols, device=device))
    x_exact = torch.as_tensor(rng.uniform(-0.5, 0.5, n), dtype=dtype, device=device)[None]
    return op, -op.matvec(x_exact), x_exact
