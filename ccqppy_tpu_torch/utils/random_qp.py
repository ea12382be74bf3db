"""Random convex-QP ensembles, generated where the generator lives.

Port of ``ccqppy_tpu/utils/random_qp.py``: Hessian ``A = G G^T`` (a
Wishart(n, I) draw, ``G`` an n x n standard normal) plus ``diag_boost * n * I``,
unconstrained optimum ``x ~ U(-1, 1)^n`` and ``b = -A x``.  Randomness comes
from an explicit ``torch.Generator``, and the tensors are made on that
generator's device.  A ``torch.Generator`` and ``jax.random`` give different
numbers from the same seed: the distribution is the same, the draws are not.
"""
from __future__ import annotations

import torch


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
