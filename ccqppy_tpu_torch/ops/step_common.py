"""What the fused step kernels' wrappers (``ops.sc_step``, ``ops.mprgp_step``)
share: the description of a set that a kernel takes (``set_args``), the
check of a kernel's state (``check_state``), and the rule that says when a
solver may hand its loop to a step kernel at all (``fused_set_args``).
Their device code shares ``csrc/step_common.cuh``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ccqppy_tpu_torch.ops.linop import LinearOperator
from ccqppy_tpu_torch.ops.projections import BlockwiseProj, BoxProj, LorentzConeProj

#: The state dtypes the step kernels have instances for, and their suffixes.
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class SetArgs(NamedTuple):
    """What a kernel needs of a set: ``kind`` "lorentz" (``p0`` mu,
    ``s0`` 0 for one mu, 1 for one a block; ``d`` the block size) or "box"
    (``p0`` lb and ``p1`` ub, ``s0`` and ``s1`` their lane strides: 0 for
    ``(n,)``, n for ``(B, n)``; ``d`` 1)."""

    kind: str
    p0: torch.Tensor
    s0: int
    p1: torch.Tensor | None
    s1: int
    d: int


def set_args(proj, b):
    """The ``SetArgs`` of ``proj`` for iterates shaped like ``b`` (B, n): a
    ``BlockwiseProj`` of a ``LorentzConeProj`` whose ``mu`` is one number or
    one a block, or a ``BoxProj`` whose bounds are ``(n,)`` or ``(B, n)``,
    each parameter contiguous in b's dtype on b's device.  None for any
    other set, or a parameter of another dtype, device or shape."""
    B, n = b.shape

    def fits(t):
        return t.dtype == b.dtype and t.device == b.device and t.is_contiguous()

    if type(proj) is BlockwiseProj and type(proj.child) is LorentzConeProj:
        d, mu = proj.block_dim, proj.child.mu
        if n % d or not fits(mu):
            return None
        if mu.dim() == 0:
            return SetArgs("lorentz", mu, 0, None, 0, d)
        if mu.shape == (n // d,):
            return SetArgs("lorentz", mu, 1, None, 0, d)
        return None
    if type(proj) is BoxProj:
        strides = []
        for t in (proj.lb, proj.ub):
            if not fits(t) or t.shape not in ((n,), (B, n)):
                return None
            strides.append(0 if t.dim() == 1 else n)
        return SetArgs("box", proj.lb, strides[0], proj.ub, strides[1], 1)
    return None


def fused_set_args(op, b, proj, trace_len):
    """``set_args`` of ``proj`` when a solver's loop may run a step kernel,
    else None: ``b`` a contiguous f32 or f64 CUDA tensor, the operator's
    ``dot`` and ``global_size`` those of ``LinearOperator`` (a sharded
    operator's all-reduce keeps the eager body), and no residual trace
    (``trace_len == 0``: a kernel records none).  A solver adds its own
    clauses."""
    if not (b.is_cuda and b.is_contiguous() and b.dtype in SUFFIX):
        return None
    if type(op).dot is not LinearOperator.dot or \
            type(op).global_size is not LinearOperator.global_size:
        return None
    if trace_len:
        return None
    return set_args(proj, b)


def check_state(what, b, groups):
    """A step kernel's state against b's: b f32 or f64, and in each group
    ``(tensors, shapes, dtype)`` every tensor contiguous on b's device, of
    ``dtype`` and of one of ``shapes``.  ``what`` names the step in the
    errors."""
    if b.dtype not in SUFFIX:
        raise TypeError(f"{what} takes f32 or f64, not {b.dtype}")
    for tensors, shapes, dtype in groups:
        for t in tensors:
            if tuple(t.shape) not in shapes or t.dtype != dtype or t.device != b.device \
                    or not t.is_contiguous():
                raise ValueError(f"{what} takes contiguous {dtype} of shape "
                                 f"{' or '.join(map(str, shapes))} on {b.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
