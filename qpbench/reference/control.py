"""The control: the reference put in the program's place, computed in TF32.

The configurations state float32 with TF32 off.  The nearest precision
below is TF32: the operands of each product rounded to 10 mantissa bits
(round to nearest, ties away from zero, as the tensor cores' conversion
does) and the sums kept in float32.  That arithmetic is emulated exactly
here (rounded operands, an f32 ``torch.bmm`` with TF32 off), so the
control gives the same answers on any device.  It takes the program's
place in a run (``prepare``/``call``, as an entry) and runs the reference's
projected gradient for a fixed ``STEPS`` steps; its answers then go
through the same check as the program's, which has to refuse them.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from qpbench.reference import solve

UNCOUNTED_SWEEPS = 0
#: Steps a call; the f64 reference reaches 1e-10 within this on every cell.
STEPS = 150


def tf32(x):
    """``x`` (f32) rounded to TF32's 10 mantissa bits, as f32."""
    if x.dtype != torch.float32:
        raise TypeError(f"TF32 rounds float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def prepare(inputs, mix):
    A = tf32(inputs.A)

    def matvec(v):
        return solve.bmv(A, tf32(v))

    return SimpleNamespace(matvec=matvec, spec=inputs.config["set"], gd=inputs.config["gd"],
                           t=solve.step_size(matvec, inputs.b0))


def call(state, b):
    x, _, _ = solve.projected_gradient(state.matvec, b, state.spec, state.gd, None, None,
                                       iters=STEPS, t=state.t)
    B = b.shape[0]
    return SimpleNamespace(x=x, converged=torch.ones(B, dtype=torch.bool, device=b.device),
                           matvecs=torch.full((B,), STEPS, dtype=torch.int32, device=b.device))
