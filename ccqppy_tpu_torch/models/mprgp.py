"""MPRGP and MPRGP-BB, batched.

Port of ``ccqppy_tpu/models/mprgp.py`` (Dostal's Modified Proportioning
with Reduced Gradient Projections and its Barzilai-Borwein variant; see
that module for the algorithm, its departures from the reference and its
measurements).  Gradient convention ``g = A x + b``.

Two forms, as in the JAX package:

* **fused** (the default): one operator application per iteration, whose
  operand each lane chooses: ``x`` when an expansion's gradient refresh is
  owed or a CG claim awaits verification, ``p`` for CG/expansion, and
  ``proj(x - alpha_bb g)`` for proportioning.  On a batch this is one
  batched matvec per iteration.
* **unfused**: the three-branch body (CG / expansion / proportioning) in
  nested verified loops.  As under ``vmap``, every branch runs on every
  lane, matvecs included, and each lane takes its own branch's values and
  counts.  It is the oracle the tests hold the fused form against.

Batching as in ``models/pcg.py``: lanes are the leading axis, every scalar
of the JAX state is a ``(B,)`` tensor, lanes that are done keep their state
through ``torch.where``, and the host reads one "any lane left?" flag per
iteration.  Values a lane does not select (``x - inf p`` when the feasible
step is unbounded) may be inf or NaN; every reduction is per lane and
every select keeps the JAX package's order, so they never reach a
selected value.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          eps_of, init_trace, lanes,
                                          make_result, pg_residual,
                                          record_trace, select_lanes,
                                          where_lanes)
from ccqppy_tpu_torch.ops.linop import as_operator
from ccqppy_tpu_torch.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class MPRGPConfig(SolverConfig):
    """gamma: proportioning threshold, ``||beta||^2 < gamma^2 ||psi||^2``.

    fused: True (default) runs the single-sweep form; False the
    three-branch form (the test oracle)."""

    gamma: float = 1.0
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class MPRGPBBConfig(MPRGPConfig):
    """expansion: second leg of the expansion step.  "bb" (default): a
    projected step along the half-point gradient with a BB step size,
    robust on curved sets.  "fixed": ``proj(x_half - (2/||A||_inf) psi)``,
    sound for polyhedral sets only."""

    expansion: str = "bb"


def _bb_step(op, dx, dg, tiny):
    """dx.dx / (dx.dg + tiny), per lane."""
    return op.dot(dx, dx) / (op.dot(dx, dg) + tiny)


class _State(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor
    p: torch.Tensor
    alpha_bb: torch.Tensor
    x_prev: torch.Tensor
    g_prev: torch.Tensor
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: torch.Tensor


def _prepare(A, b, x0, proj):
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    x_init = proj.project(default_x0(b, x0, proj))
    return op, proj, x_init


def _solve(A, b, x0, proj, config, bb_variant):
    """The three-branch form in nested verified loops."""
    op, proj, x_init = _prepare(A, b, x0, proj)
    tiny = eps_of(b)
    gamma2 = config.gamma**2
    budget, tol = config.max_matvecs, config.tol
    B = b.shape[0]
    fixed_exp = bb_variant and config.expansion == "fixed"
    alpha_bar = lanes(2.0 / op.inf_norm()) if fixed_exp else None

    g_init = op.matvec(x_init) + b
    res0 = pg_residual(proj, x_init, g_init, config.gd, op)
    if bb_variant:
        alpha_bb0 = torch.zeros_like(res0)   # sentinel: seed on first use
        mv0 = 1
    else:
        # Seeded up front, one counted matvec (no tiny: as the JAX package).
        alpha_bb0 = op.dot(g_init, g_init) / op.dot(g_init, op.matvec(g_init))
        mv0 = 2
    psi0, _ = proj.free_chopped(x_init, g_init)
    mv = torch.full((B,), mv0, dtype=torch.int32, device=b.device)
    o = _State(x=x_init, g=g_init, p=psi0, alpha_bb=alpha_bb0, x_prev=x_init,
               g_prev=g_init, res=res0, mv=mv,
               it=torch.zeros(B, dtype=torch.int32, device=b.device),
               done=(res0 < tol) | (mv >= budget),
               trace=init_trace(config, B, b.dtype, b.device))

    def body(s):
        psi, beta_ch = proj.free_chopped(s.x, s.g)
        proportional = op.dot(beta_ch, beta_ch) < gamma2 * op.dot(psi, psi)

        # ---- CG or expansion -------------------------------------------
        Ap = op.matvec(s.p)
        mv_ce = s.mv + 1
        pAp = op.dot(s.p, Ap) + tiny
        alpha_cg = op.dot(psi, s.p) / pAp
        alpha_f = op.reduce_min(proj.max_feasible_step(s.x, s.p))
        # CG
        x_cg = s.x - lanes(alpha_cg) * s.p
        g_cg = s.g - lanes(alpha_cg) * Ap
        psi_cg, _ = proj.free_chopped(x_cg, g_cg)
        p_cg = psi_cg - lanes(op.dot(psi_cg, Ap) / pAp) * s.p
        a_cg = op.dot(s.p, s.p) / pAp
        # expansion: half step to the boundary, then a projected step
        xh = s.x - lanes(alpha_f) * s.p
        gh = s.g - lanes(alpha_f) * Ap
        if fixed_exp:
            psih, _ = proj.free_chopped(xh, gh)
            x_ex = proj.project(xh - alpha_bar * psih)
        else:
            x_ex = proj.project(xh - lanes(a_cg) * gh)
        g_ex = op.matvec(x_ex) + b
        psi_ex, _ = proj.free_chopped(x_ex, g_ex)
        a_ex = _bb_step(op, x_ex - s.x, g_ex - s.g, tiny)
        take_cg = alpha_cg <= alpha_f
        ce = (where_lanes(take_cg, x_cg, x_ex), where_lanes(take_cg, g_cg, g_ex),
              where_lanes(take_cg, p_cg, psi_ex), where_lanes(take_cg, a_cg, a_ex),
              where_lanes(take_cg, mv_ce, mv_ce + 1))

        # ---- proportioning: a BB-sized step along the full gradient ------
        if bb_variant:
            seed_needed = s.alpha_bb == 0
            a_seed = op.dot(s.g, s.g) / (op.dot(s.g, op.matvec(s.g)) + tiny)
            a_hist = _bb_step(op, s.x - s.x_prev, s.g - s.g_prev, tiny)
            a_pp = torch.where(seed_needed, a_seed, a_hist)
            mv_pp = s.mv + seed_needed.to(torch.int32)
        else:
            a_pp, mv_pp = s.alpha_bb, s.mv
        x_pp = proj.project(s.x - lanes(a_pp) * s.g)
        g_pp = op.matvec(x_pp) + b
        psi_pp, _ = proj.free_chopped(x_pp, g_pp)
        pp = (x_pp, g_pp, psi_pp, _bb_step(op, x_pp - s.x, g_pp - s.g, tiny), mv_pp + 1)

        x1, g1, p1, a_bb, mv = (where_lanes(proportional, c, q) for c, q in zip(ce, pp))
        res = pg_residual(proj, x1, g1, config.gd, op)
        # ``mv + 1``: one matvec of budget is reserved for the verification.
        done = (res < tol) | (mv + 1 >= budget)
        return _State(x1, g1, p1, a_bb, s.x, s.g, res, mv, s.it + 1, done,
                      record_trace(s.trace, s.it, res))

    while True:
        outer = ~o.done
        if not any_lane(outer):
            break
        s = o
        while True:
            active = outer & ~s.done
            if not any_lane(active):
                break
            s = select_lanes(active, body(s), s)
        # Verification sweep for every outer-active lane, with the exact
        # matvec (the JAX package uses op.matvec here; the two are the same
        # for every operator ported so far).
        g_t = op.matvec_exact(s.x) + b
        mv = s.mv + 1
        res_t = pg_residual(proj, s.x, g_t, config.gd, op)
        psi_t, _ = proj.free_chopped(s.x, g_t)
        done = (res_t < tol) | (mv >= budget)
        o = select_lanes(outer, _State(s.x, g_t, psi_t, s.alpha_bb, s.x_prev, s.g_prev,
                                  res_t, mv, s.it, done, s.trace), o)

    result = make_result(o.x, o.res, o.mv, o.it, budget, o.trace)
    # o.res is a fresh-gradient residual on every exit path.
    return dataclasses.replace(result, converged=result.converged & (o.res < tol))


class _FusedState(NamedTuple):
    x: torch.Tensor
    g: torch.Tensor          # exact gradient at x, except pending: gradient at xh
    p: torch.Tensor
    x_prev: torch.Tensor     # expansion start point
    g_prev: torch.Tensor
    alpha_bb: torch.Tensor
    pending: torch.Tensor    # an expansion's gradient refresh is owed
    verifying: torch.Tensor  # a CG convergence claim awaits a fresh-g check
    res: torch.Tensor
    mv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: torch.Tensor


def _solve_fused(A, b, x0, proj, config, bb_variant):
    """Single-sweep MPRGP: one operator application per iteration, the
    branch chosen per lane by select.  Same iterates and matvec totals as
    the three-branch form, except that the BB seed ``g.g / g.Ag`` is spent
    at init (+1 matvec where the first proportioning step is away from the
    initial iterate) and an expansion's residual lands one iteration later."""
    op, proj, x_init = _prepare(A, b, x0, proj)
    tiny = eps_of(b)
    gamma2 = config.gamma**2
    budget, tol = config.max_matvecs, config.tol
    B = b.shape[0]
    fixed_exp = bb_variant and config.expansion == "fixed"
    alpha_bar = lanes(2.0 / op.inf_norm()) if fixed_exp else None

    g_init = op.matvec(x_init) + b
    res0 = pg_residual(proj, x_init, g_init, config.gd, op)
    alpha_bb0 = op.dot(g_init, g_init) / (op.dot(g_init, op.matvec(g_init)) + tiny)
    psi0, _ = proj.free_chopped(x_init, g_init)
    false = torch.zeros(B, dtype=torch.bool, device=b.device)
    s = _FusedState(x=x_init, g=g_init, p=psi0, x_prev=x_init, g_prev=g_init,
                    alpha_bb=alpha_bb0, pending=false, verifying=false, res=res0,
                    mv=torch.full((B,), 2, dtype=torch.int32, device=b.device),
                    it=torch.zeros(B, dtype=torch.int32, device=b.device),
                    done=(res0 < tol) | (2 >= budget),
                    trace=init_trace(config, B, b.dtype, b.device))

    def body(s):
        # ---- operand selection -------------------------------------------
        # For a pending lane (x, g) is the inconsistent (x1, gh) pair; what
        # is computed from it here is dropped by the selects.
        psi, beta_ch = proj.free_chopped(s.x, s.g)
        proportional = op.dot(beta_ch, beta_ch) < gamma2 * op.dot(psi, psi)
        x_prop = proj.project(s.x - lanes(s.alpha_bb) * s.g)
        dx_prop = x_prop - s.x
        br_fin = s.pending | s.verifying
        br_cg_ex = ~br_fin & proportional
        v = where_lanes(br_fin, s.x, where_lanes(br_cg_ex, s.p, x_prop))
        Av = op.matvec(v)                                   # the one sweep
        mv = s.mv + 1

        # ---- expansion finish / claim verify: fresh g at x (Av == A x) ----
        g_fin = Av + b
        a_fin = _bb_step(op, s.x - s.x_prev, g_fin - s.g_prev, tiny)
        # ---- proportioning: fresh gradient at x_prop (Av == A x_prop) -----
        g_pp = Av + b
        a_pp = _bb_step(op, dx_prop, g_pp - s.g, tiny)
        # ---- CG / expansion (Av == A p) -----------------------------------
        pAp = op.dot(s.p, Av) + tiny
        alpha_cg = op.dot(psi, s.p) / pAp
        alpha_f = op.reduce_min(proj.max_feasible_step(s.x, s.p))
        take_cg = alpha_cg <= alpha_f
        x_cg = s.x - lanes(alpha_cg) * s.p
        g_cg = s.g - lanes(alpha_cg) * Av
        a_cgbb = op.dot(s.p, s.p) / pAp
        xh = s.x - lanes(alpha_f) * s.p
        gh = s.g - lanes(alpha_f) * Av
        if fixed_exp:
            psih, _ = proj.free_chopped(xh, gh)
            x_ex = proj.project(xh - alpha_bar * psih)
        else:
            x_ex = proj.project(xh - lanes(a_cgbb) * gh)

        # ---- merge -------------------------------------------------------
        br_cg = br_cg_ex & take_cg
        br_ex = br_cg_ex & ~take_cg

        def sel(fin, cg, ex, pp):
            return where_lanes(br_fin, fin, where_lanes(br_cg, cg, where_lanes(br_ex, ex, pp)))

        x1 = sel(s.x, x_cg, x_ex, x_prop)
        g1 = sel(g_fin, g_cg, gh, g_pp)
        # A verification moves nothing, so its secant pair is stale: keep
        # the carried BB step.
        a1 = where_lanes(s.verifying, s.alpha_bb, sel(a_fin, a_cgbb, s.alpha_bb, a_pp))
        x_prev1 = where_lanes(br_ex, s.x, s.x_prev)
        g_prev1 = where_lanes(br_ex, s.g, s.g_prev)

        psi1, _ = proj.free_chopped(x1, g1)
        bcg = op.dot(psi1, Av) / pAp
        p1 = where_lanes(br_cg, psi1 - lanes(bcg) * s.p, psi1)
        p1 = where_lanes(br_ex, torch.zeros_like(p1), p1)

        res1 = pg_residual(proj, x1, g1, config.gd, op)
        # An expansion's gradient is not exact yet: keep the last honest
        # residual; the finish iteration reports the refreshed one.
        res = where_lanes(br_ex, s.res, res1)
        # The CG residual is carried by recurrence and may only claim; the
        # claim is verified by a refresh next iteration.
        fresh_now = br_fin | (~br_fin & ~proportional)
        done = ((res < tol) & fresh_now & ~br_ex) | (mv >= budget)
        verifying1 = br_cg & (res1 < tol) & ~done
        pending1 = br_ex & ~done
        # A budget exit on an expansion returns the pre-expansion iterate,
        # whose residual is the one reported.
        x1 = where_lanes(br_ex & done, s.x, x1)
        return _FusedState(x1, g1, p1, x_prev1, g_prev1, a1, pending1, verifying1,
                           res, mv, s.it + 1, done, record_trace(s.trace, s.it, res))

    while True:
        active = ~s.done
        if not any_lane(active):
            break
        s = select_lanes(active, body(s), s)
    # Every converged exit carries a fresh-gradient residual; budget exits
    # are unconverged by the mv < max semantics.
    return make_result(s.x, s.res, s.mv, s.it, budget, s.trace)


def solve(A, b, x0=None, proj=None, config: MPRGPConfig = MPRGPConfig()):
    """MPRGP on a batch: A ``(B, n, n)`` tensor or operator, b ``(B, n)``."""
    run = _solve_fused if config.fused else _solve
    return run(A, b, x0, proj, config, bb_variant=False)


def solve_bb(A, b, x0=None, proj=None, config: MPRGPBBConfig = MPRGPBBConfig()):
    """MPRGP-BB on a batch: alternating-BB proportioning and the expansion
    rule of ``config.expansion``."""
    if config.expansion not in ("bb", "fixed"):
        raise ValueError(f"expansion must be 'bb' or 'fixed', not {config.expansion!r}")
    run = _solve_fused if config.fused else _solve
    return run(A, b, x0, proj, config, bb_variant=True)
