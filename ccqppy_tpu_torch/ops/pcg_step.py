"""One iteration of ``models.pcg``'s plain inner loop on a box after its
GEMV, fused into one launch of the hand-written Hopper kernel
``csrc/pcg_step.cu``.

The kernel replaces no TPU kernel: the JAX package runs the body of
``_solve``'s inner loop as XLA fusions around its matvec, where the port's
eager body launches ~100 small kernels an iteration.  From ``A p`` it
computes, per running lane and in place, what that body
(``models.pcg._body``) and the select of the running lanes compute: the
step, the new ``x``, ``g``, ``m``, ``p``, ``rr``, the Eq. 25 residual
``res``, ``mv``, ``it`` and the inner ``done``, and it clears ``active``
where a lane is done, so that the loop's next test reads ``active`` alone.
A lane that does not run keeps every field; ``r`` is not written, as
nothing reads it after the step.

It takes one set, described by ``ops.step_common.set_args``'s "box" kind
(bounds ``(n,)`` or ``(B, n)``), for ``n <= MAX_N``, with Jacobi's
``1 / diag A`` (``(n,)`` or ``(B, n)``) or no preconditioner.  ``cg_step``
is the eager projected CG step, which plain PCG runs on every other set,
the CPU and the sharded operators, and rr-PCG always; ``plain_step``, the
kernel's plain version, is ``cg_step`` on a box with the body's flags,
written in place.  ``step`` runs the plain version for a CPU tensor and
launches the kernel for a CUDA one.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.ops import kernels
from ccqppy_tpu_torch.ops.linop import LinearOperator
from ccqppy_tpu_torch.ops.projections import BoxProj
from ccqppy_tpu_torch.ops.step_common import SUFFIX, check_state

#: Number of kernel launches in this process.
LAUNCHES = 0

#: Coordinates a thread holds, and the block sizes the kernel has.
ELEMS = 4
THREADS = (128, 256, 512)
#: The widest lane the kernel takes: one block holds it in registers.
MAX_N = ELEMS * THREADS[-1]

#: The plain step's operator: ``LinearOperator``'s own dot and size.
_OP = LinearOperator()


def threads(n):
    """The fewest threads of a block that give each at most ``ELEMS`` of
    the lane's ``n`` coordinates."""
    return next(t for t in THREADS if ELEMS * t >= n)


def cg_step(op, proj, prec, tiny, s, Ap=None):
    """One projected CG step from ``s`` (fields x, g, m, p, rr) with one
    ``op.matvec`` sweep, or on ``Ap = A p`` when the caller has taken it:
    returns the new (x, g, m, r, p, rr)."""
    if Ap is None:
        Ap = op.matvec(s.p)
    pAp = op.dot(s.p, s.m * Ap)
    alpha_cg = s.rr / (pAp + tiny)
    # max_feasible_step is defined for steps x - a*q; we move along +p.
    alpha_f = op.reduce_min(proj.max_feasible_step(s.x, -s.p))
    alpha = torch.minimum(alpha_cg, torch.clamp(alpha_f, min=0.0))
    # project() only clears fp dust: the step is feasible by construction.
    x = proj.project(s.x + alpha[:, None] * s.p)
    g = s.g + alpha[:, None] * Ap
    # Snap newly-binding coordinates exactly onto their bound (see
    # Projection.snap_binding).
    x = proj.snap_binding(x, g)
    m = proj.binding_mask(x, g)
    changed = (m != s.m).any(dim=-1)
    r = -m * g
    z = m * prec(r)
    rr = op.dot(r, z)
    restart = changed | (alpha_f < alpha_cg)
    beta = torch.where(restart, 0.0, rr / (s.rr + tiny))
    return x, g, m, r, z + beta[:, None] * s.p, rr


def _check(b, ap, s, active, dinv):
    """Shapes, dtypes, devices and layout of the state against b's."""
    B, n = b.shape
    groups = [((ap, b, s.x, s.g, s.m, s.p), ((B, n),), b.dtype),
              ((s.rr, s.res), ((B,),), b.dtype), ((s.mv, s.it), ((B,),), torch.int32),
              ((s.done, active), ((B,),), torch.bool)]
    if dinv is not None:
        groups.append(((dinv,), ((n,), (B, n)), b.dtype))
    check_state("the fused PCG step", b, groups)
    if n > MAX_N:
        raise ValueError(f"the fused PCG step takes n <= {MAX_N}, not {n}")


def plain_step(sargs, ap, b, s, active, dinv, *, tol, gd, budget, tiny):
    """The kernel's plain version, in place on ``s``: ``cg_step`` on the box
    of ``sargs`` with ``A p = ap``, the body's residual and flags, and every
    written field taken where ``active``, then ``active`` cleared where
    done.  Arguments as ``step``'s."""
    prec = (lambda r: r) if dinv is None else (lambda r: dinv * r)
    proj = BoxProj(sargs.p0, sargs.p1)
    x, g, m, _, p, rr = cg_step(_OP, proj, prec, tiny, s, ap)
    mv = s.mv + 1
    pg = proj.pg_residual_vec(x, g, gd)
    res = torch.sqrt(_OP.dot(pg, pg)) / (3.0 * _OP.global_size(x))
    done = (res < tol) | (mv + 1 >= budget) | (rr == 0)
    for t, new in ((s.x, x), (s.g, g), (s.m, m), (s.p, p)):
        t.copy_(torch.where(active[:, None], new, t))
    for t, new in ((s.rr, rr), (s.res, res), (s.mv, mv), (s.it, s.it + 1), (s.done, done)):
        t.copy_(torch.where(active, new, t))
    active.copy_(active & ~done)


def step(sargs, ap, b, s, active, dinv, *, tol, gd, budget, tiny):
    """One fused iteration of plain PCG's inner loop, in place on the state.

    ``ap`` (B, n) is ``A p`` (read only); ``s`` a ``models.pcg._State``
    whose ``x``, ``g``, ``m``, ``p`` (B, n) and ``rr``, ``res`` (B,) have
    b's dtype, ``mv``, ``it`` (B,) int32 and ``done`` (B,) bool; ``active``
    (B,) bool the lanes that run, cleared where the step sets done; ``dinv``
    Jacobi's ``1 / diag A`` ((n,) or (B, n), b's dtype) or None; every
    tensor contiguous on b's device and ``sargs`` the box's ``SetArgs``.  ``tiny`` is the step sizes' guard.
    On the card the kernel runs on the current stream."""
    if sargs.kind != "box":
        raise ValueError(f"the fused PCG step takes a box, not {sargs.kind!r}")
    _check(b, ap, s, active, dinv)
    B, n = b.shape
    if b.device.type != "cuda":
        plain_step(sargs, ap, b, s, active, dinv, tol=tol, gd=gd, budget=budget, tiny=tiny)
        return
    if B == 0 or n == 0:
        return
    kernels.launch(f"pcg_step_box_{SUFFIX[b.dtype]}", b.device,
                   *(t.data_ptr() for t in (ap, s.x, s.g, s.m, s.p, s.rr, s.res, s.mv, s.it,
                                            s.done, active)),
                   None if dinv is None else dinv.data_ptr(),
                   0 if dinv is None or dinv.dim() == 1 else n,
                   sargs.p0.data_ptr(), sargs.s0, sargs.p1.data_ptr(), sargs.s1, float(gd),
                   float(tiny), B, n, float(tol), int(budget), threads(n))
    kernels.count(_count)


def _count():
    global LAUNCHES
    LAUNCHES += 1
