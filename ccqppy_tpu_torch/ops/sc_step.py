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

It takes two sets, described by ``ops.step_common.set_args``: a
``BlockwiseProj`` of a ``LorentzConeProj`` whose ``mu`` is one number or
one a block, and a ``BoxProj`` whose bounds are ``(n,)`` or ``(B, n)``.  Its plain version is
the eager body, ``models.apgd._sc_body``, which every other set, the CPU
and the sharded operators run.  On a CPU tensor ``step`` raises: no path
calls it there.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.ops import kernels
from ccqppy_tpu_torch.ops.step_common import SUFFIX, check_state

#: Number of kernel launches in this process.
LAUNCHES = 0


def _check(b, rows, lanes, ints, flags):
    """Shapes, dtypes, devices and layout of the state against b's."""
    B, n = b.shape
    check_state("the fused apgd_sc step", b,
                ((rows, ((B, n),), b.dtype), (lanes, ((B,), (B, 1)), b.dtype),
                 (ints, ((B,),), torch.int32), (flags, ((B,),), torch.bool)))


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
    kernels.launch(f"apgd_sc_step_{sargs.kind}_{SUFFIX[b.dtype]}", b.device,
                   *(t.data_ptr() for t in (Av, b, x, y, v, res, mv, it, done, verifying,
                                            L, beta)),
                   *params, B, n, float(tol), int(budget), int(bool(restart)))
    LAUNCHES += 1
