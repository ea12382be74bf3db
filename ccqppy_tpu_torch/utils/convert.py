"""Carry problems, sets and configurations over from the JAX package.

These let both packages solve the same problem with the same set and the
same configuration.  Nothing here imports JAX: arrays are read through
``np.asarray`` and classes are matched by name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccqppy_tpu_torch.models.base import SolverConfig
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.ops.linop import DenseOperator, SymmetricPackedDense

_CONFIGS = {"SolverConfig": SolverConfig, "PCGConfig": PCGConfig}


def problem_from_numpy(A, b, device, dtype):
    """Batched arrays A (B, n, n), b (B, n) -> contiguous tensors on
    ``device`` in ``dtype``."""
    A = torch.as_tensor(np.asarray(A), dtype=dtype, device=device)
    b = torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
    return A.contiguous(), b.contiguous()


def operator_from_jax(op, device, dtype):
    """The port's counterpart of a JAX ``DenseOperator`` or
    ``SymmetricPackedDense``, with its arrays on ``device`` in ``dtype``.
    ``Ap``, ``diag``, ``n`` and ``tile`` carry over as they are; a single
    problem gains a leading lane axis of one.  The arrays are copied."""
    def tensor(v, batched_dim):
        t = torch.as_tensor(np.array(v), dtype=dtype, device=device)
        return (t[None] if t.dim() < batched_dim else t).contiguous()

    name = type(op).__name__
    if name == "DenseOperator":
        return DenseOperator(tensor(op.A, 3))
    if name == "SymmetricPackedDense":
        return SymmetricPackedDense(tensor(op.Ap, 4), tensor(op.diag, 2),
                                    int(op.n), int(op.tile))
    raise NotImplementedError(f"{name} is not ported yet")


def _array(v):
    return torch.from_numpy(np.array(v))


def proj_from_jax(proj):
    """The port's counterpart of a JAX projection, with the same bounds in
    the same dtype, on the CPU (move it with ``.to(device)``)."""
    name = type(proj).__name__
    if name == "IdentityProj":
        return P.IdentityProj()
    if name == "BoxProj":
        return P.BoxProj(_array(proj.lb), _array(proj.ub))
    if name == "LowerBoundProj":
        return P.LowerBoundProj(_array(proj.lb))
    if name == "UpperBoundProj":
        return P.UpperBoundProj(_array(proj.ub))
    raise NotImplementedError(f"{name} is not ported yet")


def config_from_jax(cfg):
    """The port's config class of the same name, field for field."""
    name = type(cfg).__name__
    if name not in _CONFIGS:
        raise NotImplementedError(f"{name} is not ported yet")
    return _CONFIGS[name](**dataclasses.asdict(cfg))
