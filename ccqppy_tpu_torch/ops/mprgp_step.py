"""One pass of ``models.mprgp``'s fused loop after its sweep, fused into
one launch of the hand-written Hopper kernel ``csrc/mprgp_step.cu``.

The kernel replaces no TPU kernel: the JAX package runs the fused MPRGP
body as XLA fusions around its sweep, where the port's eager body launches
~600 small kernels a pass.  From the sweep's f64 ``A v`` it computes, per
lane and in place, what that body and the select of the lanes still
running compute (the branch's step sizes, the new ``x``, ``g``, ``p``,
``alpha_bb``, ``x_prev``, ``g_prev``, the Eq. 25 residual, ``res``, ``mv``,
``it``, ``done``, ``pending``, ``verifying``), then what the next pass needs
before its sweep: ``psi``, the free part of the new ``(x, g)``, the lane's
proportioning test ``prop``, and the next operand ``v`` in f64.  A lane
already done keeps every field.  ``operand`` runs the same kernel on its
last part alone: the first operand of a loop, from the state as it stands.

It takes one set, described by ``ops.step_common.set_args``'s "lorentz"
kind: a ``BlockwiseProj`` of a ``LorentzConeProj`` whose ``mu`` is one
number or one a block, in the state's dtype.  Its plain version is the eager body of
``models.mprgp._solve_fused`` (``_fused_body``), which every other set, the
CPU and the sharded operators run, and so does a solve that keeps a
residual trace (``trace_len > 0``): the kernel records none.  On a CPU
tensor ``step`` and ``operand`` raise: no path calls them there.
``LAUNCHES`` counts the launches that ran; one recorded while a CUDA graph
captures counts once a replay (``kernels.graph_capture``), as the GEMV's
do.
"""
from __future__ import annotations

import functools

import torch

from ccqppy_tpu_torch.ops import kernels
from ccqppy_tpu_torch.ops.step_common import SUFFIX, check_state

#: Number of kernel launches in this process (both modes).
LAUNCHES = 0

_STEP, _OPERAND = 0, 1
#: Units (Lorentz blocks) a lane needs before it takes a cluster of blocks.
_WIDE_UNITS = 2048
#: Blocks of a thread block cluster, one lane's (the portable largest).
_CLUSTER = 8


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def geometry(device, B, units):
    """(threads a block, blocks a lane) for B lanes of ``units`` Lorentz
    blocks each: a cluster of eight blocks of 256 threads where a lane
    carries ``_WIDE_UNITS`` or more and eight SMs a lane are free (B = 1,
    n = 9999), else one block of 128 (every block resident at once at
    B = 1024, n = 999)."""
    if units >= _WIDE_UNITS and _CLUSTER * B <= _sm_count(device):
        return 256, _CLUSTER
    return 128, 1


def _check(b, rows, v, lanes, ints, flags):
    """Shapes, dtypes, devices and layout of the state against b's."""
    B, n = b.shape
    check_state("the fused MPRGP step", b,
                ((rows, ((B, n),), b.dtype), (v, ((B, n),), torch.float64),
                 (lanes, ((B,),), b.dtype), (ints, ((B,),), torch.int32),
                 (flags, ((B,),), torch.bool)))


def _launch(mode, sargs, av, b, s, psi, v, prop, tol, budget, gamma2, tiny):
    if b.device.type != "cuda":
        raise ValueError(f"the fused MPRGP step runs on cuda, not {b.device}")
    if sargs.kind != "lorentz":
        raise ValueError(f"the fused MPRGP step takes a Lorentz-block set, not {sargs.kind!r}")
    rows = (b, s.x, s.g, s.p, s.x_prev, s.g_prev, psi)
    _check(b, rows, (v,) if av is None else (av, v), (s.alpha_bb, s.res), (s.mv, s.it),
           (s.done, s.pending, s.verifying, prop))
    B, n = b.shape
    if B == 0 or n == 0:
        return
    kernels.launch(f"mprgp_step_lorentz_{SUFFIX[b.dtype]}", b.device,
                   (v if av is None else av).data_ptr(),
                   *(t.data_ptr() for t in (b, s.x, s.g, s.p, s.x_prev, s.g_prev, psi, v,
                                            s.alpha_bb, s.res, s.mv, s.it, s.done, s.pending,
                                            s.verifying, prop)),
                   sargs.p0.data_ptr(), sargs.s0, sargs.d, B, n, float(tol), int(budget),
                   float(gamma2), float(tiny), mode, *geometry(b.device, B, n // sargs.d))
    kernels.count(_count)


def _count():
    global LAUNCHES
    LAUNCHES += 1


def step(sargs, av, b, s, psi, v, prop, *, tol, budget, gamma2, tiny):
    """One fused pass, in place on the state.

    ``av`` (B, n) f64 is ``A v`` (read only); ``s`` a ``_FusedState`` whose
    ``x``, ``g``, ``p``, ``x_prev``, ``g_prev`` (B, n) and ``alpha_bb``,
    ``res`` (B,) have b's dtype, ``mv``, ``it`` (B,) int32, ``done``,
    ``pending``, ``verifying`` (B,) bool; ``psi`` (B, n) in b's dtype, ``v``
    (B, n) f64 and ``prop`` (B,) bool as the last launch left them; every
    tensor contiguous on b's CUDA device.  ``gamma2`` is gamma squared and
    ``tiny`` the secant steps' guard.  The kernel runs on the current
    stream."""
    _launch(_STEP, sargs, av, b, s, psi, v, prop, tol, budget, gamma2, tiny)


def operand(sargs, b, s, psi, v, prop, *, gamma2):
    """The next operand of every lane not done, from the state ``s`` as it
    stands: ``psi`` and ``prop`` of ``(x, g)``, and ``v``, written in place
    (a done lane's ``v`` is its ``x``).  Arguments as ``step``'s."""
    _launch(_OPERAND, sargs, None, b, s, psi, v, prop, 0.0, 0, gamma2, 0.0)
