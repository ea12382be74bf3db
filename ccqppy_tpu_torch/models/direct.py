"""Direct-factorization serving mode: fixed Hessians, streaming right-hand
sides.

Port of ``ccqppy_tpu/models/direct.py`` (see it for the rationale).  With
the ensemble of Hessians fixed, a batched inverse is one-time preparation:

  prep (once):  A^-1 for every lane via batched Cholesky (``spd_inverse_batch``)
  per call:     x0 = proj(A^-1 (-b))         -- one sweep of A^-1
                g  = A x0 + b; Eq. 25 residual -- one verification sweep of A
                straggler lanes polish with warm-started, compacted PCG.

Exact fp32 matters here: a TF32 inverse or apply carries ~1e-3 relative
error, far above the serving tolerance.  Callers on CUDA keep
``torch.backends.cuda.matmul.allow_tf32`` off.
"""
from __future__ import annotations

import dataclasses

import torch

from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.gemv import batched_gemv


def spd_inverse_batch(As):
    """Batched SPD inverse via Cholesky: ``A^-1 = L^-T L^-1`` per lane, in
    the dtype of ``As``.  At B=1024, n=1000 in f32, ``As``, the factor and
    the inverse (4.1 GB each) fit side by side on one 80 GB card, so the
    batch is not chunked.  The result is made row-major contiguous, the
    layout the GEMV kernel takes (on CUDA ``cholesky_inverse`` returns
    column-major matrices)."""
    L = torch.linalg.cholesky(As)
    return torch.cholesky_inverse(L).contiguous()


def direct_x0(Ainv, b, proj):
    """Projected inverse apply ``proj(A^-1 (-b))`` -- the direct warm start,
    through the batched GEMV kernel."""
    return proj.project(batched_gemv(Ainv, -b))


def solve_direct_batched(Ainv, A, b, proj, config: PCGConfig = None,
                         phase1=3, bucket=64, host_fallback=True):
    """Direct-serving batched solve: warm start from the precomputed
    inverse, verify with one fresh sweep, polish stragglers with compacted
    warm-started PCG.  Matvec counts include the A^-1 application (+1 per
    lane), so totals reflect every operator-sized sweep spent."""
    from ccqppy_tpu_torch.parallel.batch import solve_batched_fused_compact

    config = config if config is not None else PCGConfig(tol=1e-5,
                                                         max_matvecs=500)
    x0 = direct_x0(Ainv, b, proj)
    r = solve_batched_fused_compact("pcg", A, b, phase1, x0=x0, proj=proj,
                                    config=config, bucket=bucket,
                                    host_fallback=host_fallback)
    return dataclasses.replace(r, matvecs=r.matvecs + 1)
