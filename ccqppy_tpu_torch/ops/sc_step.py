"""One iteration of ``models.apgd.solve_sc`` after its GEMV, fused into
one launch of the hand-written Hopper kernel ``csrc/apgd_sc_step.cu``.

The kernel replaces no TPU kernel: the JAX package runs the body of
``solve_sc``'s loop as one XLA fusion around its GEMV, where the port's
eager body launches ~220 small kernels an iteration.  From ``A v`` it
computes, per lane and in place, what that body and the select of the lanes
still running compute: the trial point ``P(y - g / L)`` (``P(x - g / L)`` on
a verifying lane), the Eq. 25 residual, the restart test, the flags, the
new ``x``, ``y``, ``res``, ``mv``, ``it``, ``done``, ``verifying``, and the
next GEMV's input ``v = where(verifying, x, y)``.  A lane already done
keeps every field.

It takes two sets, described by ``set_args``: a ``BlockwiseProj`` of a
``LorentzConeProj`` whose ``mu`` is one number or one a block, and a
``BoxProj`` whose bounds are ``(n,)`` or ``(B, n)``.  Its plain version is
the eager body, ``models.apgd._sc_body``, which every other set, the CPU
and the sharded operators run.  On a CPU tensor ``step`` raises: no path
calls it there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ccqppy_tpu_torch.ops import kernels
from ccqppy_tpu_torch.ops.projections import BlockwiseProj, BoxProj, LorentzConeProj

#: Number of kernel launches in this process.
LAUNCHES = 0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class SetArgs(NamedTuple):
    """What the kernel needs of a set: ``kind`` "lorentz" (``p0`` mu,
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
    """The kernel's ``SetArgs`` of ``proj`` for iterates shaped like ``b``
    (B, n), or None when the kernel does not take the set: any set but those
    two, or a parameter of another dtype or device than b's, or of another
    shape than those listed in the module docstring."""
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


def _check(b, rows, lanes, ints, flags):
    """Shapes, dtypes, devices and layout of the state against b's."""
    if b.dtype not in _SUFFIX:
        raise TypeError(f"the fused apgd_sc step takes f32 or f64, not {b.dtype}")
    B = b.shape[0]
    for tensors, shapes, dtype in ((rows, ((B, b.shape[1]),), b.dtype),
                                   (lanes, ((B,), (B, 1)), b.dtype),
                                   (ints, ((B,),), torch.int32), (flags, ((B,),), torch.bool)):
        for t in tensors:
            if tuple(t.shape) not in shapes or t.dtype != dtype or t.device != b.device \
                    or not t.is_contiguous():
                raise ValueError(f"the fused apgd_sc step takes contiguous {dtype} of shape "
                                 f"{' or '.join(map(str, shapes))} on {b.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")


def step(sargs, Av, b, x, y, v, res, mv, it, done, verifying, L, beta, *, tol, gd,
         budget, restart):
    """One fused iteration of ``solve_sc``, in place on the state.

    ``Av`` (B, n) is ``A v`` (read only); ``x``, ``y``, ``v`` (B, n) and
    ``res`` (B,) have b's dtype; ``mv``, ``it``
    (B,) int32; ``done``, ``verifying`` (B,) bool; ``L``, ``beta`` (B,) or
    (B, 1) in b's dtype; every tensor contiguous on b's CUDA device.  The
    kernel runs on the current stream."""
    global LAUNCHES
    if b.device.type != "cuda":
        raise ValueError(f"the fused apgd_sc step runs on cuda, not {b.device}")
    _check(b, (Av, b, x, y, v), (res, L, beta), (mv, it), (done, verifying))
    B, n = b.shape
    if B == 0 or n == 0:
        return
    if sargs.kind == "lorentz":
        params = (sargs.p0.data_ptr(), sargs.s0, sargs.d)
    else:
        params = (sargs.p0.data_ptr(), sargs.s0, sargs.p1.data_ptr(), sargs.s1, float(gd))
    fn = getattr(kernels.load(), f"apgd_sc_step_{sargs.kind}_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (Av, b, x, y, v, res, mv, it, done, verifying,
                                          L, beta)),
                 *params, B, n, float(tol), int(budget), int(bool(restart)), stream)
    if err != 0:
        raise RuntimeError(f"apgd_sc step kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
