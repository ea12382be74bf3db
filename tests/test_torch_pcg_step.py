"""The fused plain-PCG step (``ops/pcg_step.py``, ``csrc/pcg_step.cu``).

CPU: the wrapper's plain step against ``select_lanes(outer & ~done,
_body(s), s)``, bit for bit, from states with lanes done, outer-inactive,
stepping onto a bound, changing their mask and left with ``rr == 0``; when
``pcg.solve`` takes the step (the predicate is also asked with the iterate
made to look like a CUDA tensor, so that each clause is seen to refuse on
its own); and, with the iterate looking like a CUDA tensor so that the
fused loop runs its plain step on the CPU, whole solves against the eager
solve, bitwise.  Card (marked ``cuda``): the kernel against the plain step
at (2048, 1000) and (256, 1000) f32 and (64, 1000) f64; a whole
``solve_batched_fused_compact`` call on a box1000-sized batch, fused
against eager, audited in f64; the three kernels an iteration; and the direct
path, which must launch no step.  This file imports no JAX: the card tests
compare with the port's own eager body.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ccqppy_tpu_torch.models import pcg
from ccqppy_tpu_torch.models.base import eps_of, select_lanes
from ccqppy_tpu_torch.models.direct import solve_direct_batched, spd_inverse_batch
from ccqppy_tpu_torch.ops import kernels, pcg_step, step_common
from ccqppy_tpu_torch.ops.linop import BlockSparseOperator, DenseOperator, LinearOperator
from ccqppy_tpu_torch.ops.projections import box, lower_bound
from ccqppy_tpu_torch.parallel import solve_batched_fused_compact

#: The inner state's fields the step writes (``r`` is not written).
WRITTEN = ("x", "g", "m", "p", "rr", "res", "mv", "it", "done")


def box_family(B, n, seed, scale=2.0):
    """A = G G^T + n I; b = -A x_uncon, x_uncon ~ U(-scale, scale), f64:
    with box [-1, 1] about half the bounds bind at the optimum."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-scale, scale, (B, n)))
    return torch.from_numpy(A), torch.from_numpy(b)


def _bounds(kind, B, n, dtype, device, gen):
    """(lb, ub): shared (n,) or one row a lane (B, n)."""
    shape = (n,) if kind == "shared" else (B, n)
    u = torch.rand((2, *shape), generator=gen, dtype=dtype, device=device)
    return -(0.5 + u[0]), 0.5 + u[1]


def _step_case(B, n, dtype, bounds, precond, device="cpu", seed=5):
    """(state, A p, b, proj, dinv, outer, budget) of an inner segment midway,
    with lanes of every kind by ``lane % 8``: 0 done, 1 outer-inactive, 2
    one matvec short of the budget, 3 its mask stale (all ones), 4 at the
    box's corners with the gradient pushing out and no direction (rr == 0
    after the step), the rest plain.  x is clipped from a wide draw, so
    that coordinates sit on the bounds, and p is the preconditioned
    steepest descent on the free set scaled by 1-1000 a lane, so that some
    lanes' steps run into a bound and others' stop short of every bound."""
    gen = torch.Generator(device=device).manual_seed(seed)
    G = torch.randn((B, n, n), generator=gen, dtype=dtype, device=device)
    A = torch.bmm(G, G.transpose(1, 2)) + n * torch.eye(n, dtype=dtype, device=device)
    del G
    b = 0.5 * n * torch.randn((B, n), generator=gen, dtype=dtype, device=device)
    lb, ub = _bounds(bounds, B, n, dtype, device, gen)
    proj = box(lb, ub, dtype, device)
    lane = torch.arange(B, device=device)
    kind = lane % 8
    x = proj.project(1.5 * torch.randn((B, n), generator=gen, dtype=dtype, device=device))
    corner = torch.where(torch.arange(n, device=device) % 2 == 0, lb, ub).expand(B, n)
    x = torch.where((kind == 4)[:, None], corner, x)
    g = torch.bmm(A, x[..., None])[..., 0] + b
    # At a corner the gradient pushes out of the box on every coordinate.
    push = torch.where(torch.arange(n, device=device) % 2 == 0, 1.0, -1.0).to(dtype)
    g = torch.where((kind == 4)[:, None], push * (1.0 + g.abs()), g)
    m = proj.binding_mask(x, g)
    m = torch.where((kind == 3)[:, None], torch.ones_like(m), m)
    dinv = None
    if precond == "jacobi":
        dinv = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=eps_of(b))
    r = -m * g
    z = m * (r if dinv is None else dinv * r)
    scale = 10.0 ** (3.0 * torch.rand((B, 1), generator=gen, dtype=dtype, device=device))
    p = torch.where((kind == 4)[:, None], torch.zeros_like(z), scale * z)
    budget = 40
    s = pcg._State(x=x, g=g, m=m, r=r, p=p, rr=(r * z).sum(-1),
                   res=torch.rand(B, generator=gen, dtype=dtype, device=device),
                   mv=torch.where(kind == 2, budget - 2, lane % 5 + 3).to(torch.int32),
                   it=(lane % 7).to(torch.int32), done=kind == 0,
                   trace=torch.zeros((B, 0), dtype=dtype, device=device))
    Ap = torch.bmm(A, p[..., None])[..., 0]
    return s, Ap, b, proj, dinv, kind != 1, budget


def _eager(s, Ap, b, proj, dinv, outer, cfg):
    """The eager body's step with the select of the running lanes."""
    prec = (lambda r: r) if dinv is None else (lambda r: dinv * r)
    new = pcg._body(s, LinearOperator(), proj, prec, eps_of(b), cfg, Ap)
    return select_lanes(outer & ~s.done, new, s)


def _fused(s, Ap, b, proj, dinv, outer, cfg):
    """``pcg_step.step`` on a copy of the state; returns the copy, whose
    ``active`` flags, which the step clears where done, must be those of
    the lanes that still run."""
    f = pcg._State(*(t.clone() for t in s))
    active = outer & ~s.done
    pcg_step.step(step_common.set_args(proj, b), Ap, b, f, active, dinv,
                  tol=cfg.tol, gd=cfg.gd, budget=cfg.max_matvecs, tiny=eps_of(b))
    assert torch.equal(active, outer & ~f.done)
    return f


def _kinds_seen(s, Ap, b, proj, ref, outer):
    """Every kind of lane the step must handle is among the running ones."""
    run = outer & ~s.done
    pAp = (s.p * (s.m * Ap)).sum(-1)
    alpha_cg = s.rr / (pAp + eps_of(b))
    alpha_f = proj.max_feasible_step(s.x, -s.p)
    assert bool((~outer).any()) and bool((outer & s.done).any())       # kept lanes
    assert bool((run & (alpha_f < alpha_cg)).any())                     # onto a bound
    assert bool((run & (alpha_f >= alpha_cg)).any())                    # a CG step
    assert bool((run & (ref.m != s.m).any(-1)).any())                   # the mask changed
    assert bool((run & (ref.rr == 0)).any())                            # nothing left to move
    assert bool((run & ref.done & (ref.rr != 0)).any())                 # the budget edge


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("bounds", ["shared", "lanes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plain_step_is_the_selected_eager_body(dtype, bounds, precond):
    s, Ap, b, proj, dinv, outer, budget = _step_case(24, 40, dtype, bounds, precond)
    cfg = pcg.PCGConfig(tol=1e-9, max_matvecs=budget, precond=precond)
    ref = _eager(s, Ap, b, proj, dinv, outer, cfg)
    _kinds_seen(s, Ap, b, proj, ref, outer)
    f = _fused(s, Ap, b, proj, dinv, outer, cfg)
    for name in WRITTEN:
        assert torch.equal(getattr(f, name), getattr(ref, name)), name
    assert torch.equal(f.r, s.r)                                        # r is not written


# ---- when pcg.solve takes the step --------------------------------------------


class _OwnReduceMin(DenseOperator):
    """An operator with a ``reduce_min`` of its own, as a row-sharded
    operator's all-reduce is."""

    def reduce_min(self, v):
        return v.clone()


class _F32Diagonal(DenseOperator):
    """An f64 operator whose diagonal is f32: Jacobi's 1 / diag A in another
    dtype than b."""

    def diagonal(self):
        return super().diagonal().float()


def _dispatch_case(case):
    """(op, b, proj, config) of a small f64 CPU problem for each case."""
    B, n = 3, 12
    A, b = box_family(B, n, 7)
    op, cfg = DenseOperator(A), pcg.PCGConfig(tol=1e-8, max_matvecs=500)
    proj = box(-torch.ones(n), torch.ones(n), torch.float64)
    if case == "trace":
        cfg = dataclasses.replace(cfg, trace_len=4)
    elif case == "rr":
        cfg = dataclasses.replace(cfg, refresh_every=8)
    elif case == "lower_bound":
        proj = lower_bound(-torch.ones(n), torch.float64)
    elif case == "scalar_bounds":
        proj = box(-1.0, 1.0, torch.float64)
    elif case == "own_reduce_min":
        op = _OwnReduceMin(A)
    elif case == "jacobi_f32_diag":
        op, cfg = _F32Diagonal(A), dataclasses.replace(cfg, precond="jacobi")
    return op, b, proj, cfg


@pytest.mark.parametrize("case", ["cpu", "trace", "rr", "lower_bound", "scalar_bounds",
                                  "own_reduce_min", "jacobi_f32_diag"])
def test_dispatch_runs_the_eager_body(case, monkeypatch):
    op, b, proj, cfg = _dispatch_case(case)
    eager, fused = pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED
    r = pcg.solve(op, b, proj=proj, config=cfg)
    assert bool(r.converged.all())
    assert pcg.PCG_STEPS_EAGER - eager >= int(r.iterations.max()) > 0
    assert pcg.PCG_STEPS_FUSED == fused
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    dinv = None
    if cfg.precond == "jacobi":
        dinv = 1.0 / torch.clamp(op.diagonal(), min=eps_of(b))
    # On the card only the first case would take the kernel.
    assert (pcg._step_args(op, b, proj, cfg, dinv) is not None) == (case == "cpu")


def test_dispatch_keeps_lanes_wider_than_a_block_eager(monkeypatch):
    """A lane wider than ``pcg_step.MAX_N`` keeps the eager body."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    cfg = pcg.PCGConfig()
    for n, want in ((pcg_step.MAX_N, True), (pcg_step.MAX_N + 1, False)):
        b = torch.zeros((2, n))
        proj = box(-torch.ones(n), torch.ones(n))
        assert (pcg._step_args(LinearOperator(), b, proj, cfg, None) is not None) == want


def test_step_threads_and_state_checks():
    assert [pcg_step.threads(n) for n in (1, 512, 513, 1000, 1024, 1025, 2048)] == \
        [128, 128, 256, 256, 256, 512, 512]
    assert {"pcg_step_box_f32", "pcg_step_box_f64"} <= set(kernels.SIGNATURES)
    assert "pcg_step.cu" in [src.name for src in kernels.sources()]
    s, Ap, b, proj, dinv, outer, budget = _step_case(8, 10, torch.float64, "shared", "none")
    sargs = step_common.set_args(proj, b)
    kw = dict(tol=1e-8, gd=1e-6, budget=budget, tiny=eps_of(b))
    with pytest.raises(ValueError, match="contiguous torch.float64"):
        pcg_step.step(sargs, Ap.float(), b, s, outer, dinv, **kw)
    with pytest.raises(ValueError, match="torch.int32"):
        pcg_step.step(sargs, Ap, b, s._replace(mv=s.mv.long()), outer, dinv, **kw)
    with pytest.raises(ValueError, match="torch.bool"):
        pcg_step.step(sargs, Ap, b, s, outer.int(), dinv, **kw)
    with pytest.raises(ValueError, match="takes a box"):
        pcg_step.step(sargs._replace(kind="lorentz"), Ap, b, s, outer, dinv, **kw)


# ---- the fused loop on the CPU, its kernel stood in for by the plain step ------


def _blocks_of(A, bs):
    """A dense stack (B, n, n) as a ``BlockSparseOperator`` with every block
    of each block row stored."""
    B, n, _ = A.shape
    nbr = n // bs
    blocks = A.unflatten(1, (nbr, bs)).unflatten(3, (nbr, bs)).permute(0, 1, 3, 2, 4)
    cols = torch.arange(nbr).expand(B, nbr, nbr)
    return BlockSparseOperator.from_dense_blocks(blocks, cols)


def _solve_case(case):
    """(solve, expected fused) of a small CPU problem for each case: a
    ``pcg.solve`` call (or a compacted one) on bounds that bind."""
    B, n = 6, 16
    A, b = box_family(B, n, 29)
    dtype = torch.float32 if case in ("f32", "f64_blocks") else torch.float64
    b = b.to(dtype)
    lb = -torch.linspace(0.5, 1.0, n, dtype=dtype)
    proj = box(lb, -lb, dtype)
    cfg = pcg.PCGConfig(tol=1e-5 if dtype == torch.float32 else 1e-9, max_matvecs=300)
    op = DenseOperator(A.to(dtype))
    if case == "lanes":
        lanes = torch.linspace(0.3, 1.0, B * n, dtype=dtype).view(B, n)
        proj = box(-lanes, lanes.flip(0).contiguous(), dtype)
    elif case == "jacobi":
        cfg = dataclasses.replace(cfg, precond="jacobi")
    elif case == "f64_blocks":
        op = _blocks_of(A, 4)
    if case == "compact":
        return (lambda: solve_batched_fused_compact("pcg", op.A, b, 6, proj=proj, config=cfg,
                                                    bucket=4, host_fallback=True)), True
    return (lambda: pcg.solve(op, b, proj=proj, config=cfg)), case != "f64_blocks"


@pytest.mark.parametrize("case", ["shared", "lanes", "jacobi", "f32", "compact",
                                  "f64_blocks"])
def test_fused_loop_on_the_plain_step_is_the_eager_solve(case, monkeypatch):
    """The fused loop, its kernel stood in for by the plain step, against the
    eager loop: the same answers bitwise, and every iteration fused, except
    where the operator's ``A p`` is f64 under an f32 b (f64 blocks): there
    the first ``A p`` hands the segment to the eager body."""
    run, fused_wanted = _solve_case(case)
    want = run()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    eager, fused = pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED
    got = run()
    assert bool(got.converged.all()) and int(got.iterations.max()) > 3
    assert bool((got.x.abs() >= 0.5).any())        # some bounds bind
    if fused_wanted:
        assert pcg.PCG_STEPS_FUSED - fused > 0 and pcg.PCG_STEPS_EAGER == eager
    else:
        assert pcg.PCG_STEPS_FUSED == fused and pcg.PCG_STEPS_EAGER - eager > 0
    for name in ("x", "residual", "matvecs", "iterations", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_direct_path_never_enters_the_loop(monkeypatch):
    """The direct path's compacted PCG starts from the projected inverse
    apply: no lane iterates, so no step runs on either path."""
    A, b = box_family(8, 16, 31, scale=0.5)
    proj = box(-torch.ones(16), torch.ones(16), torch.float64)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    eager, fused = pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED
    r = solve_direct_batched(torch.linalg.inv(A), A, b, proj,
                             pcg.PCGConfig(tol=1e-8, max_matvecs=100))
    assert bool(r.converged.all()) and bool((r.matvecs == 2).all())
    assert (pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED) == (eager, fused)


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ulps(got, want, old, eps):
    """max |got - want| in units of eps times the larger of the two states'
    largest entries."""
    scale = max(float(want.abs().max()), float(old.abs().max()), 1e-300)
    return float((got - want).abs().max()) / (eps * scale)


#: Vectors' tolerance in ulps of the larger state's largest entry: the
#: kernel sums each lane's p.(m A p) and r.z in another order than
#: PyTorch's reduction, so alpha and beta differ by a few ulps, and x, g
#: and p by a few ulps of the terms alpha p, alpha A p and beta p.
VECTOR_ULPS = 16


@pytest.mark.cuda
@pytest.mark.parametrize("B, dtype, bounds, precond", [
    (2048, torch.float32, "shared", "none"), (256, torch.float32, "lanes", "jacobi"),
    (64, torch.float64, "shared", "jacobi")], ids=["2048_f32", "256_f32", "64_f64"])
def test_kernel_matches_the_plain_step(cuda, B, dtype, bounds, precond):
    n = 1000
    s, Ap, b, proj, dinv, outer, budget = _step_case(B, n, dtype, bounds, precond, cuda)
    cfg = pcg.PCGConfig(tol=1.0, max_matvecs=budget, precond=precond)
    # The residuals do not depend on tol: put tol in the widest gap between
    # two of them near the median of the running lanes, so that no flag
    # rests on the order of a sum.
    ref = _eager(s, Ap, b, proj, dinv, outer, cfg)
    res = ref.res[outer & ~s.done & (ref.rr != 0)].sort().values
    mid = len(res) // 2
    k = max(range(mid - 4, mid + 4), key=lambda i: float(res[i + 1] / res[i]))
    cfg = dataclasses.replace(cfg, tol=float(torch.sqrt(res[k] * res[k + 1])))
    ref = _eager(s, Ap, b, proj, dinv, outer, cfg)
    _kinds_seen(s, Ap, b, proj, ref, outer)
    assert bool((ref.done & (ref.res < cfg.tol)).any())

    before = pcg_step.LAUNCHES
    f = _fused(s, Ap, b, proj, dinv, outer, cfg)
    torch.cuda.synchronize()
    assert pcg_step.LAUNCHES == before + 1
    kept = ~(outer & ~s.done)
    for name in pcg._State._fields[:-1]:
        assert torch.equal(getattr(f, name)[kept], getattr(s, name)[kept]), name
    for name in ("m", "mv", "it", "done"):
        assert torch.equal(getattr(f, name), getattr(ref, name)), name
    eps = torch.finfo(dtype).eps
    for name in ("x", "g", "p"):
        ulps = _ulps(getattr(f, name), getattr(ref, name), getattr(s, name), eps)
        assert ulps <= VECTOR_ULPS, (name, ulps)
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(f.rr, ref.rr, rtol=rel, atol=0)
    torch.testing.assert_close(f.res, ref.res, rtol=rel, atol=0)


B_SOLVE, N_SOLVE, TOL_SOLVE = 2048, 1000, 2e-5


@pytest.fixture(scope="module")
def box1000():
    """box1000's family at its size: B = 2048, n = 1000, A = G G^T + n I in
    f32 on the card (8.2 GB), b = -A x_uncon with x_uncon ~ U(-1, 1), box
    [-1, 1], and the Jacobi start clip(-b / diag A)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1000)
    A, b, _ = random_qp_batch(gen, B_SOLVE, N_SOLVE, torch.float32, diag_boost=1.0, chunk=256)
    proj = box(-torch.ones(N_SOLVE), torch.ones(N_SOLVE), device=dev)
    x0 = torch.clamp(-b / A.diagonal(dim1=-2, dim2=-1), -1.0, 1.0)
    return A, b, proj, x0


def _audit(A, b, x, chunk=256):
    """Each lane's Eq. 25 residual on box [-1, 1], from A and b in f64."""
    out = []
    for i in range(0, len(b), chunk):
        A64, x64 = A[i:i + chunk].double(), x[i:i + chunk].double()
        g = torch.bmm(A64, x64[..., None])[..., 0] + b[i:i + chunk].double()
        r = torch.clamp(g, (x64 - 1) / 1e-6, (x64 + 1) / 1e-6)
        out.append(torch.linalg.vector_norm(r, dim=-1) / (3.0 * x.shape[-1]))
    return torch.cat(out)


@pytest.mark.cuda
def test_fused_compacted_solve_against_the_eager_one(box1000):
    """box1000.iterative's call, fused and eager (a one-entry trace keeps the
    eager body): every converged lane audits under tol x 1.05 in f64 on both
    paths, the same lanes converge, and the fused call steps only on the
    kernel.  The matvec counts of a lane may differ by the order of its
    sums; the count of such lanes is printed."""
    A, b, proj, x0 = box1000
    cfg = pcg.PCGConfig(tol=TOL_SOLVE, max_matvecs=500)

    def call(c):
        return solve_batched_fused_compact("pcg", A, b, 17, x0=x0, proj=proj, config=c,
                                           bucket=256, host_fallback=False)

    eager, fused, launches = pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED, pcg_step.LAUNCHES
    rf = call(cfg)
    torch.cuda.synchronize()
    steps = pcg.PCG_STEPS_FUSED - fused
    assert steps > 0 and pcg.PCG_STEPS_EAGER == eager
    assert pcg_step.LAUNCHES - launches == steps
    re = call(dataclasses.replace(cfg, trace_len=1))
    assert pcg.PCG_STEPS_EAGER - eager > 0 and pcg.PCG_STEPS_FUSED - fused == steps
    for r in (rf, re):
        conv = r.converged
        assert float(conv.float().mean()) > 0.99
        assert float(_audit(A, b, r.x)[conv].max()) <= TOL_SOLVE * 1.05
    differ = int((rf.matvecs != re.matvecs).sum())
    print(f"fused against eager: {differ} of {B_SOLVE} lanes differ in matvecs; mean "
          f"{float(rf.matvecs.float().mean()):.4f} against {float(re.matvecs.float().mean()):.4f}")
    assert abs(float(rf.matvecs.float().mean() - re.matvecs.float().mean())) < 0.2


@pytest.mark.cuda
def test_fused_solve_launches_three_kernels_an_iteration(box1000):
    """A fused inner iteration is the GEMV, the step and the flag's ``any``,
    counted in the profiler's device events over one uncompacted solve."""
    from torch.autograd import DeviceType

    A, b, proj, x0 = box1000
    A, b, x0 = A[:256], b[:256], x0[:256]
    cfg = pcg.PCGConfig(tol=TOL_SOLVE, max_matvecs=500)
    pcg.solve(A, b, x0=x0, proj=proj, config=cfg)         # warm-up
    torch.cuda.synchronize()
    fused = pcg.PCG_STEPS_FUSED
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pcg.solve(A, b, x0=x0, proj=proj, config=cfg)
        torch.cuda.synchronize()
    steps = pcg.PCG_STEPS_FUSED - fused
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and not e.name.startswith(("Memcpy", "Memset"))]
    # One GEMV for the start, one a fused iteration, one a segment's
    # verification.
    segments = sum("batched_gemv" in name for name in names) - steps - 1
    print(f"{len(names)} kernels for {steps} fused iterations and {segments} segments")
    assert steps > 0 and segments > 0
    assert sum("pcg_step_kernel" in name for name in names) == steps
    # Every fused iteration's three, and what the start, each segment's
    # start and its verification launch eagerly (~70 kernels a segment).
    assert len(names) <= 3 * steps + 100 * (segments + 1), len(names)


@pytest.mark.cuda
def test_direct_path_launches_no_step_kernel(box1000):
    """box1000.direct's call (the projected inverse apply, then compacted PCG
    at phase 1 = 3) launches no step kernel: no lane iterates."""
    A, b, proj, _ = box1000
    A, b = A[:256], b[:256]
    Ainv = spd_inverse_batch(A)
    cfg = pcg.PCGConfig(tol=TOL_SOLVE, max_matvecs=500)
    eager, fused, launches = pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED, pcg_step.LAUNCHES
    r = solve_direct_batched(Ainv, A, b, proj, cfg, phase1=3, bucket=64, host_fallback=False)
    torch.cuda.synchronize()
    assert bool(r.converged.all())
    assert (pcg.PCG_STEPS_EAGER, pcg.PCG_STEPS_FUSED, pcg_step.LAUNCHES) == \
        (eager, fused, launches)
