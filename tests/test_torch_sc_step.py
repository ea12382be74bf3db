"""The fused ``apgd_sc`` step (``ops/sc_step.py``, ``csrc/apgd_sc_step.cu``).

CPU: when ``solve_sc`` takes it.  Every case below runs the eager body; the
predicate is also asked with the iterate made to look like a CUDA tensor, so
that each clause is seen to refuse on its own (or, for the sets the kernel
takes, to accept).  With the kernel stood in for by its plain version (its
argument checks, then the eager body in place), the fused loop runs whole
solves on the CPU and must give the eager solve bitwise, a start shared by
the lanes and an operator that promotes ``A v`` included.  Card (marked
``cuda``): one fused step against the eager
body ``apgd._sc_body`` from the same state, with lanes in every branch, in
f32 and f64; then whole solves at B = 64, n = 999 against the eager body on
the card and the f64 CPU solve, and the launches an iteration.  This file
imports no JAX: the card tests compare with the port's own eager body.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ccqppy_tpu_torch.models import apgd
from ccqppy_tpu_torch.models.base import select_lanes
from ccqppy_tpu_torch.ops import sc_step, step_common
from ccqppy_tpu_torch.ops.linop import (BlockSparseOperator, LinearOperator, SpectralDense,
                                        estimate_spectral_bounds)
from ccqppy_tpu_torch.ops.projections import (LorentzConeProj, ball, blockwise, box,
                                              lorentz_cone, segment_product)


def cone_family(B, n, seed, scale=1.0):
    """A = G G^T + n I; b = -A x_uncon, x_uncon ~ U(-scale, scale), f64."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-scale, scale, (B, n)))
    return torch.from_numpy(A), torch.from_numpy(b)


class _OwnDot(SpectralDense):
    """An operator with a ``dot`` of its own, as a sharded operator's
    all-reduce is."""

    def dot(self, u, v):
        return (u * v).sum(dim=-1)


def _dispatch_case(case):
    """(op, b, proj, config) of a small f64 CPU problem for each case."""
    A, b = cone_family(3, 12, 11)
    L, mu = estimate_spectral_bounds(A)
    op, cfg = SpectralDense(A, L, mu), apgd.APGDSCConfig(tol=1e-8, max_matvecs=500)
    proj = blockwise(lorentz_cone(1.0, torch.float64), 3)
    if case == "trace":
        cfg = dataclasses.replace(cfg, trace_len=4)
    elif case == "own_dot":
        op = _OwnDot(A, L, mu)
    elif case == "ball":
        proj = ball(2.0, dtype=torch.float64)
    elif case == "segment":
        one = torch.ones(3, dtype=torch.float64)
        proj = segment_product(*[(lorentz_cone(1.0, torch.float64), 3),
                                 (box(-one, one, torch.float64), 3)] * 2)
    return op, b, proj, cfg


@pytest.fixture
def looks_cuda(monkeypatch):
    """Every tensor answers ``is_cuda`` True: the predicate's other clauses
    are then what decides."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


@pytest.mark.parametrize("case", ["cpu", "trace", "own_dot", "ball", "segment"])
def test_dispatch_runs_the_eager_body(case, monkeypatch):
    op, b, proj, cfg = _dispatch_case(case)
    eager, fused = apgd.SC_STEPS_EAGER, apgd.SC_STEPS_FUSED
    r = apgd.solve_sc(op, b, proj=proj, config=cfg)
    assert bool(r.converged.all())
    assert apgd.SC_STEPS_EAGER - eager == int(r.iterations.max())
    assert apgd.SC_STEPS_FUSED == fused
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    sargs = step_common.fused_set_args(op, b, proj, cfg.trace_len)
    # On the card only the first case would take the kernel.
    assert (sargs is not None) == (case == "cpu")


@pytest.mark.parametrize("kind", ["shared_mu", "per_block_mu", "box_n", "box_lanes"])
def test_predicate_takes_lorentz_blocks_and_boxes(kind, looks_cuda):
    B, n = 3, 12
    b = torch.zeros((B, n), dtype=torch.float64)
    lb, ub = -torch.ones(n, dtype=torch.float64), torch.ones(n, dtype=torch.float64)
    mu = torch.linspace(0.5, 2.0, n // 3, dtype=torch.float64)
    proj, want = {
        "shared_mu": (blockwise(lorentz_cone(1.0, torch.float64), 3), ("lorentz", 0, 3)),
        "per_block_mu": (blockwise(LorentzConeProj(mu), 3, child_axes=0), ("lorentz", 1, 3)),
        "box_n": (box(lb, ub, torch.float64), ("box", 0, 1)),
        "box_lanes": (box(lb.expand(B, n), ub.expand(B, n).contiguous(), torch.float64),
                      ("box", n, 1)),
    }[kind]
    op = SpectralDense(torch.eye(n, dtype=torch.float64).expand(B, n, n),
                       torch.ones(B, dtype=torch.float64), torch.ones(B, dtype=torch.float64))
    sargs = step_common.fused_set_args(op, b, proj, 0)
    if kind == "box_lanes":
        # A broadcast (stride-0) bound is not contiguous: the eager body.
        assert sargs is None
        proj = box(lb.expand(B, n).contiguous(), ub.expand(B, n).contiguous(), torch.float64)
        sargs = step_common.fused_set_args(op, b, proj, 0)
    assert (sargs.kind, sargs.s0, sargs.d) == want
    if sargs.kind == "box":
        assert sargs.s1 == sargs.s0 and sargs.p1 is proj.ub
    # A parameter in another dtype than the iterates, or blocks that do not
    # tile n, keep the eager body.
    assert step_common.set_args(proj.float(), b) is None
    assert step_common.set_args(blockwise(lorentz_cone(1.0, torch.float64), 5), b) is None


def _plain_step(proj):
    """``sc_step.step`` as its plain version, for the CPU: the kernel's
    argument checks, then one eager iteration on ``A v`` with the select of
    the running lanes, written in place, and the next GEMV's input."""
    def step(sargs, Av, b, x, y, v, res, mv, it, done, verifying, L, beta, *, tol, gd,
             budget, restart):
        sc_step._check(b, (Av, b, x, y, v), (res, L, beta), (mv, it), (done, verifying))
        assert sargs == step_common.set_args(proj, b)
        s = apgd._SCState(x, y, res, mv, it, done, verifying, x.new_zeros((len(x), 0)))
        cfg = apgd.APGDSCConfig(tol=tol, gd=gd, max_matvecs=budget, restart=restart)
        new = select_lanes(~done, apgd._sc_body(s, LinearOperator(), b, proj, L, beta, cfg,
                                                Av), s)
        for t, t_new in zip(s[:-1], new[:-1]):
            t.copy_(t_new)
        v.copy_(torch.where(new.verifying[:, None], new.x, new.y))
    return step


def _blocks_of(A, bs):
    """A dense stack (B, n, n) as a ``BlockSparseOperator`` with every block
    of each block row stored."""
    B, n, _ = A.shape
    nbr = n // bs
    blocks = A.unflatten(1, (nbr, bs)).unflatten(3, (nbr, bs)).permute(0, 1, 3, 2, 4)
    cols = torch.arange(nbr).expand(B, nbr, nbr)
    return BlockSparseOperator.from_dense_blocks(blocks, cols)


@pytest.mark.parametrize("case", ["shared_mu", "per_block_mu", "box_n", "box_lanes",
                                  "shared_x0", "f64_blocks"])
def test_fused_loop_on_the_plain_step_is_the_eager_solve(case, monkeypatch):
    """The fused loop, its kernel stood in for by the plain step, against the
    eager loop: the same answers bitwise, and every iteration fused, except
    where the operator's ``A v`` is f64 under an f32 b (f64 blocks): there
    the first ``A v`` hands every iteration to the eager body."""
    B, n = 4, 12
    A, b = cone_family(B, n, 23, scale=2.0)
    dtype = torch.float32 if case == "f64_blocks" else torch.float64
    b = b.to(dtype)
    one = torch.ones(n, dtype=dtype)
    proj = {"shared_mu": blockwise(lorentz_cone(0.8, dtype), 3),
            "per_block_mu": blockwise(LorentzConeProj(
                torch.linspace(0.5, 2.0, n // 3, dtype=dtype)), 3, child_axes=0),
            "box_n": box(-one, one, dtype),
            "box_lanes": box(-torch.linspace(0.2, 1.0, B * n, dtype=dtype).view(B, n),
                             torch.linspace(1.0, 0.2, B * n, dtype=dtype).view(B, n), dtype),
            "shared_x0": blockwise(lorentz_cone(0.8, dtype), 3),
            "f64_blocks": blockwise(lorentz_cone(0.8, dtype), 3)}[case]
    op = _blocks_of(A, 3) if case == "f64_blocks" else SpectralDense(
        A, *estimate_spectral_bounds(A))
    x0 = torch.full((n,), 0.25, dtype=dtype) if case == "shared_x0" else None
    cfg = apgd.APGDSCConfig(tol=1e-7, max_matvecs=400)
    want = apgd.solve_sc(op, b, x0, proj, cfg)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(sc_step, "step", _plain_step(proj))
    eager, fused = apgd.SC_STEPS_EAGER, apgd.SC_STEPS_FUSED
    got = apgd.solve_sc(op, b, x0, proj, cfg)
    steps = int(got.iterations.max())
    assert steps > 3 and bool(got.converged.any())
    if case == "f64_blocks":
        assert got.x.dtype == torch.float64
        assert (apgd.SC_STEPS_FUSED - fused, apgd.SC_STEPS_EAGER - eager) == (0, steps)
    else:
        assert (apgd.SC_STEPS_FUSED - fused, apgd.SC_STEPS_EAGER - eager) == (steps, 0)
    for name in ("x", "residual", "matvecs", "iterations", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# name -> (set, block size, n, per-block mu or per-lane bounds)
SETS = {"lorentz3": ("lorentz", 3, 999, False),
        "lorentz3_mu_per_block": ("lorentz", 3, 999, True),
        "lorentz5": ("lorentz", 5, 1000, False), "box_shared": ("box", 1, 999, False),
        "box_per_lane": ("box", 1, 999, True)}


def _step_case(name, dtype, dev, B=64, seed=17):
    """A state with lanes in every branch: lane % 8 == 0 done, 1-3
    verifying, 4-7 not; lane % 16 == 5 one matvec short of the budget; each
    lane's g scaled by its own decade, so that the residuals spread over
    six decades and a tol between two of them splits the lanes."""
    kind, d, n, per = SETS[name]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    if kind == "lorentz":
        mu = uni(0.5, 2.0, n // d) if per else torch.tensor(0.8, dtype=dtype, device=dev)
        proj = blockwise(LorentzConeProj(mu), d, child_axes=0 if per else None)
    else:
        shape = (B, n) if per else (n,)
        proj = box(-uni(0.2, 1.0, *shape), uni(0.2, 1.0, *shape), dtype, dev)
    lane = torch.arange(B, device=dev)
    scale = torch.logspace(-3, 3, B, dtype=dtype, device=dev)[torch.randperm(
        B, generator=torch.Generator().manual_seed(seed)).to(dev)][:, None]
    budget = 50
    x = proj.project(2 * rnd(B, n))
    x[:, :d] = 0                                   # one block at the apex on every lane
    s = apgd._SCState(
        x=x, y=1.5 * rnd(B, n), res=uni(0.0, 1.0, B),
        mv=torch.where(lane % 16 == 5, budget - 1, lane % 7 + 3).to(torch.int32),
        it=(lane % 5 + 2).to(torch.int32), done=lane % 8 == 0,
        verifying=(lane % 8 >= 1) & (lane % 8 <= 3),
        trace=torch.zeros((B, 0), dtype=dtype, device=dev))
    Av, b = scale * rnd(B, n), scale * rnd(B, n)
    L, beta = uni(5.0, 50.0, B, 1), uni(0.1, 0.9, B, 1)
    return s, Av, b, proj, L, beta, budget


def _both(s, Av, b, proj, L, beta, cfg):
    """(eager state after one selected iteration, fused state, fused v)."""
    ref = select_lanes(~s.done, apgd._sc_body(s, LinearOperator(), b, proj, L, beta, cfg, Av),
                       s)
    f = apgd._SCState(*(t.clone() for t in s))
    v = torch.where(f.verifying[:, None], f.x, f.y)
    before, Av0 = sc_step.LAUNCHES, Av.clone()
    sc_step.step(step_common.set_args(proj, b), Av, b, f.x, f.y, v, f.res, f.mv, f.it,
                 f.done, f.verifying, L, beta, tol=cfg.tol, gd=cfg.gd,
                 budget=cfg.max_matvecs, restart=cfg.restart)
    torch.cuda.synchronize()
    assert sc_step.LAUNCHES == before + 1 and torch.equal(Av, Av0)
    return ref, f, v


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(SETS))
def test_fused_step_matches_the_eager_body(cuda, name, dtype, restart):
    s, Av, b, proj, L, beta, budget = _step_case(name, dtype, cuda)
    cfg = apgd.APGDSCConfig(tol=1.0, max_matvecs=budget, restart=restart)
    assert step_common.set_args(proj, b) is not None
    # The residuals do not depend on tol: put tol in the widest gap between
    # two of them near the median of the running lanes.
    res = _both(s, Av, b, proj, L, beta, cfg)[0].res[~s.done].sort().values
    mid = len(res) // 2
    k = max(range(mid - 4, mid + 4), key=lambda i: float(res[i + 1] / res[i]))
    assert float(res[k + 1] / res[k]) > 1.01
    cfg = dataclasses.replace(cfg, tol=float(torch.sqrt(res[k] * res[k + 1])))
    ref, f, v = _both(s, Av, b, proj, L, beta, cfg)

    # Every branch of the step is taken on some lane.
    ver, run = s.verifying, ~s.done
    assert bool((run & ver & ref.done & (ref.mv < budget)).any())      # verifying exit
    assert bool((run & ver & ~ref.done).any())                         # failed claim
    assert bool((run & ~ver & ref.verifying).any())                    # a new claim
    assert bool((run & ~ver & ~ref.verifying & ~ref.done).any())       # a plain step
    assert bool((run & ref.done & (ref.mv >= budget)).any())           # the budget edge
    if SETS[name][0] == "lorentz":
        d = SETS[name][1]
        cone = proj.child
        p = (s.y - (Av + b) / L).unflatten(-1, (-1, d))
        u, z = p[..., :-1], p[..., -1]
        un = torch.sqrt((u * u).sum(-1))
        inside, polar = un <= cone.mu * z, cone.mu * un <= -z
        assert bool(inside.any()) and bool(polar.any()) and bool((~inside & ~polar).any())
        xb = s.x.unflatten(-1, (-1, d))
        assert bool(cone.is_apex(xb).any()) and bool(cone.is_active(xb).any()) and \
            bool((~cone.is_active(xb)).any())

    # Lanes that were done: every field bitwise as it was.
    done = s.done
    for name_, a, b_ in zip(apgd._SCState._fields, f, s):
        if name_ != "trace":
            assert torch.equal(a[done], b_[done]), name_
    # The flags and counts exactly; x, y, v to rounding; res to the order of its sum.
    for name_ in ("mv", "it", "done", "verifying"):
        assert torch.equal(getattr(f, name_), getattr(ref, name_)), name_
    eps = torch.finfo(dtype).eps
    for got, want in ((f.x, ref.x), (f.y, ref.y),
                      (v, torch.where(ref.verifying[:, None], ref.x, ref.y))):
        torch.testing.assert_close(got, want, rtol=4 * eps,
                                   atol=4 * eps * float(want.abs().max()))
    torch.testing.assert_close(f.res, ref.res, rtol=1e-5 if dtype == torch.float32 else 1e-12,
                               atol=0)


B_SOLVE, N_SOLVE = 64, 999


@pytest.fixture(scope="module")
def solve_problem():
    """The cone ensemble's family at B = 64, n = 999: A in f64 on the card,
    b = -A x_uncon with x_uncon ~ U(-1, 1) (the cone) or U(-2, 2) (the box,
    so that bounds bind)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(999)
    G = torch.randn((B_SOLVE, N_SOLVE, N_SOLVE), generator=gen, device=dev,
                    dtype=torch.float64)
    A = torch.bmm(G, G.transpose(1, 2)) + N_SOLVE * torch.eye(N_SOLVE, device=dev,
                                                               dtype=torch.float64)
    del G
    xu = 2 * torch.rand((B_SOLVE, N_SOLVE), generator=gen, device=dev, dtype=torch.float64) - 1
    return A, -torch.bmm(A, xu[..., None])[..., 0], dev


def _solve_set(kind, dtype, dev):
    if kind == "cone":
        return blockwise(lorentz_cone(1.0, dtype, dev), 3)
    one = torch.ones(N_SOLVE, dtype=dtype, device=dev)
    return box(-one, one, dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cone", "box"])
def test_fused_solve_matches_the_eager_solve(solve_problem, kind):
    A64, b64, dev = solve_problem
    if kind == "box":
        b64 = 2 * b64
    A32, b32 = A64.float(), b64.float()
    op = SpectralDense(A32, *estimate_spectral_bounds(A32))
    cfg = apgd.APGDSCConfig(tol=1e-5, max_matvecs=2000)
    eager, fused, launches = apgd.SC_STEPS_EAGER, apgd.SC_STEPS_FUSED, sc_step.LAUNCHES
    rf = apgd.solve_sc(op, b32, proj=_solve_set(kind, torch.float32, dev), config=cfg)
    torch.cuda.synchronize()
    steps = apgd.SC_STEPS_FUSED - fused
    assert apgd.SC_STEPS_EAGER == eager and steps == int(rf.iterations.max())
    assert sc_step.LAUNCHES - launches == steps
    # A trace keeps the eager body, on the same card and operator.
    re = apgd.solve_sc(op, b32, proj=_solve_set(kind, torch.float32, dev),
                       config=dataclasses.replace(cfg, trace_len=1))
    assert apgd.SC_STEPS_EAGER - eager == int(re.iterations.max())
    assert torch.equal(rf.converged, re.converged) and bool(rf.converged.all())
    off = (rf.matvecs - re.matvecs).abs()
    assert float((off <= 1).float().mean()) >= 0.99, off.tolist()
    A, b = A64.cpu(), b64.cpu()
    r64 = apgd.solve_sc(SpectralDense(A, *estimate_spectral_bounds(A)), b,
                        proj=_solve_set(kind, torch.float64, "cpu"), config=cfg)
    # Both within 3 n tol / lambda_min(A) = 3 tol of the optimum.
    np.testing.assert_allclose(rf.x.cpu().numpy(), r64.x.numpy(), rtol=0, atol=6e-5)


@pytest.mark.cuda
def test_fused_solve_launches_four_kernels_an_iteration(solve_problem):
    """An iteration is the GEMV, the step and the flag's two kernels
    (``~done``, ``any``), counted in the profiler's device events from the
    first GEMV to the last step, which the last flag's two follow."""
    from torch.autograd import DeviceType

    A64, b64, dev = solve_problem
    A32, b32 = A64.float(), b64.float()
    op = SpectralDense(A32, *estimate_spectral_bounds(A32))
    cfg = apgd.APGDSCConfig(tol=1e-5, max_matvecs=2000)
    proj = _solve_set("cone", torch.float32, dev)
    apgd.solve_sc(op, b32, proj=proj, config=cfg)          # warm-up
    torch.cuda.synchronize()
    fused = apgd.SC_STEPS_FUSED
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        apgd.solve_sc(op, b32, proj=proj, config=cfg)
        torch.cuda.synchronize()
    steps = apgd.SC_STEPS_FUSED - fused
    kernels_ = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not e.name.startswith(("Memcpy", "Memset")))
    names = [name for _, name in kernels_]
    first = next(i for i, name in enumerate(names) if "batched_gemv" in name)
    assert steps > 0
    assert sum("apgd_sc_step_kernel" in name for name in names) == steps
    assert sum("batched_gemv" in name for name in names) == steps
    last = max(i for i, name in enumerate(names) if "apgd_sc_step_kernel" in name)
    assert last + 1 - first <= 4 * steps - 2, names[first:first + 12]
