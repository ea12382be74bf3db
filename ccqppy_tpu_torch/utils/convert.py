"""Carry problems, sets and configurations over from the JAX package.

These let both packages solve the same problem with the same set and the
same configuration.  Nothing here imports JAX: arrays are read through
``np.asarray`` and classes are matched by name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccqppy_tpu_torch.models.apgd import APGDConfig, APGDSCConfig
from ccqppy_tpu_torch.models.base import SolverConfig
from ccqppy_tpu_torch.models.bbpgd import BBPGDConfig, BBPGDfConfig
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig, MPRGPConfig
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.models.pgd import PGDConfig
from ccqppy_tpu_torch.models.spg import SPGConfig
from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.ops.linop import (BlockSparseOperator, CastDense,
                                        DenseOperator, FastDense,
                                        MixedPrecDense, SpectralDense,
                                        SymmetricPackedDense)

_CONFIGS = {c.__name__: c for c in (SolverConfig, PCGConfig, APGDConfig,
                                    APGDSCConfig, MPRGPConfig, MPRGPBBConfig,
                                    PGDConfig, BBPGDConfig, BBPGDfConfig,
                                    SPGConfig)}


def problem_from_numpy(A, b, device, dtype):
    """Batched arrays A (B, n, n), b (B, n) -> contiguous tensors on
    ``device`` in ``dtype``."""
    A = torch.as_tensor(np.asarray(A), dtype=dtype, device=device)
    b = torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
    return A.contiguous(), b.contiguous()


def operator_from_jax(op, device, dtype):
    """The port's counterpart of a JAX ``DenseOperator``, ``FastDense``,
    ``CastDense``, ``MixedPrecDense``, ``SymmetricPackedDense``,
    ``SpectralDense`` or ``BlockSparseOperator``, with its arrays on
    ``device`` in ``dtype``; the two stacks of ``MixedPrecDense`` (f32 and
    bf16, or f64 and f32) and the stack of ``CastDense`` keep their own
    dtypes (a bfloat16 array is read through float32, which is exact), and
    block-sparse ``cols`` become int64.  ``Ap``, ``diag``, ``n``, ``tile``,
    ``L`` and ``mu`` carry over as they are; a single problem (or block-sparse
    operator) gains a leading lane axis of one.  The arrays are copied."""
    def tensor(v, batched_dim, dtype=dtype):
        """``v`` as a tensor, in ``dtype`` or, for None, in its own."""
        a = np.array(v)
        if a.dtype.name == "bfloat16":      # ml_dtypes, which torch cannot read
            t = torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        else:
            t = torch.as_tensor(a, device=device)
        t = t if dtype is None else t.to(dtype)
        return (t[None] if t.dim() < batched_dim else t).contiguous()

    name = type(op).__name__
    if name == "DenseOperator":
        return DenseOperator(tensor(op.A, 3))
    if name == "FastDense":
        return FastDense(tensor(op.A, 3))
    if name == "CastDense":
        return CastDense(tensor(op.A, 3, None))
    if name == "MixedPrecDense":
        return MixedPrecDense(tensor(op.A, 3, None), tensor(op.A_low, 3, None))
    if name == "SpectralDense":
        return SpectralDense(tensor(op.A, 3), tensor(op.L, 1), tensor(op.mu, 1))
    if name == "SymmetricPackedDense":
        return SymmetricPackedDense(tensor(op.Ap, 4), tensor(op.diag, 2),
                                    int(op.n), int(op.tile))
    if name == "BlockSparseOperator":
        return BlockSparseOperator(tensor(op.blocks, 5), tensor(op.cols, 3, torch.int64))
    raise NotImplementedError(f"{name} is not ported yet")


def _array(v):
    return torch.from_numpy(np.array(v))


def proj_from_jax(proj):
    """The port's counterpart of a JAX projection, with the same parameters
    in the same dtype, on the CPU (move it with ``.to(device)``).  A
    composition converts its children; a ``SegmentProj`` group keeps its
    stacked parameters, which broadcast over the group's blocks."""
    name = type(proj).__name__
    if name == "IdentityProj":
        return P.IdentityProj()
    if name == "BoxProj":
        return P.BoxProj(_array(proj.lb), _array(proj.ub))
    if name == "LowerBoundProj":
        return P.LowerBoundProj(_array(proj.lb))
    if name == "UpperBoundProj":
        return P.UpperBoundProj(_array(proj.ub))
    if name == "BallProj":
        return P.BallProj(_array(proj.radius), _array(proj.center))
    if name == "LorentzConeProj":
        return P.LorentzConeProj(_array(proj.mu))
    if name == "BlockwiseProj":
        return P.BlockwiseProj(proj_from_jax(proj.child), proj.block_dim, proj.child_axes)
    if name == "ProductProj":
        return P.ProductProj(*((proj_from_jax(c), d) for c, d in zip(proj.children, proj.dims)))
    if name == "SegmentProj":
        return P.SegmentProj([proj_from_jax(c) for c in proj.children],
                             [_array(i) for i in proj.indices], proj.dims)
    raise NotImplementedError(f"{name} is not ported yet")


def config_from_jax(cfg):
    """The port's config class of the same name, field for field."""
    name = type(cfg).__name__
    if name not in _CONFIGS:
        raise NotImplementedError(f"{name} is not ported yet")
    return _CONFIGS[name](**dataclasses.asdict(cfg))
