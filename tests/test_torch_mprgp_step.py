"""The fused MPRGP step (``ops/mprgp_step.py``, ``csrc/mprgp_step.cu``).

CPU: when the fused MPRGP loop takes it.  The predicate is asked with the
iterate made to look like a CUDA tensor, so that each clause is seen to
refuse on its own (or, for the sets the kernel takes, to accept).  With the
kernel stood in for by its plain version (its argument checks, then the
eager body and its select in place, then the next operand) and the graphs'
captures and replays by eager runs, whole fused solves on the CPU must give
the eager solve bitwise, from the graphs cached across calls and from the
loop that replays a graph of a pass; the cache's key must change with
everything its graphs read by pointer or bake in.  Card (marked ``cuda``):
one step against the eager body ``mprgp._fused_body`` with its select from
one state, with lanes in every branch, in f32 with f64 sweeps and in f64;
whole solves at (64, 999) and (1, 9999) against the eager loop (at n =
9999 over twelve draws of b); the cached graphs bitwise against the loop
that replays a pass; and the kernels of a pass as the profiler sees them.
This file imports no JAX: the card tests compare with the port's own eager
body.
"""
import dataclasses

import pytest
import torch

from ccqppy_tpu_torch.models import base, mprgp
from ccqppy_tpu_torch.models.base import select_lanes, where_lanes
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig, MPRGPConfig
from ccqppy_tpu_torch.ops import gemv, kernels, loop_flag, mprgp_step, step_common
from ccqppy_tpu_torch.ops.linop import DenseOperator, LinearOperator, ShardedDenseOperator
from ccqppy_tpu_torch.ops.projections import (LorentzConeProj, ball, blockwise, box,
                                              lorentz_cone, segment_product)
from ccqppy_tpu_torch.parallel import batch
from qpbench.reference import sets
from qpbench.reference import solve as reference

SPEC = {"kind": "lorentz_blocks", "block_dim": 3, "mu": 1.0}


def problem(n, B, seed, dtype, device="cpu"):
    """cone999's family at width n: ``A = G G^T + n I``, ``b = -A x_u + 1e-3
    N(0, 1)``, ``x_u ~ U(-1, 1)``, drawn in f64 on the CPU, made on
    ``device``."""
    g = torch.Generator().manual_seed(seed)
    G = torch.randn((B, n, n), generator=g, dtype=torch.float64).to(device)
    A = G @ G.mT + n * torch.eye(n, dtype=torch.float64, device=device)
    xu = (2 * torch.rand((B, n), generator=g, dtype=torch.float64) - 1).to(device)
    noise = torch.randn((B, n), generator=g, dtype=torch.float64).to(device)
    b = -(A @ xu[..., None])[..., 0] + 1e-3 * noise
    return A.to(dtype), b.to(dtype)


def cone(dtype, device="cpu", per_block=None):
    """Lorentz blocks of 3: mu 1, or ``per_block`` (nblk,) mu values."""
    if per_block is None:
        return blockwise(lorentz_cone(1.0, dtype=dtype, device=device), 3)
    return blockwise(LorentzConeProj(per_block.to(device=device, dtype=dtype)), 3,
                     child_axes=0)


class _OwnDot(DenseOperator):
    """A dense operator with a ``dot`` of its own, as a sharded operator's
    all-reduce is."""

    def dot(self, u, v):
        return (u * v).sum(dim=-1)


def _sharded(A):
    """A ``ShardedDenseOperator`` of one rank, built without a process group:
    only its type is asked."""
    op = object.__new__(ShardedDenseOperator)
    op.A_local, op.group, op.world, op.rank = A, None, 1, 0
    return op


def _dispatch_case(case):
    """(op, b, proj, config, fixed_exp) of a small f64 problem for each case."""
    A, b = problem(12, 3, 11, torch.float64)
    op, proj = DenseOperator(A), cone(torch.float64)
    cfg, fixed = MPRGPBBConfig(tol=1e-8, max_matvecs=500), False
    one = torch.ones(12, dtype=torch.float64)
    if case == "sharded":
        op = _sharded(A)
    elif case == "own_dot":
        op = _OwnDot(A)
    elif case == "box":
        proj = box(-one, one, torch.float64)
    elif case == "ball":
        proj = ball(2.0, dtype=torch.float64)
    elif case == "segment":
        proj = segment_product(*[(lorentz_cone(1.0, torch.float64), 3),
                                 (box(-one[:3], one[:3], torch.float64), 3)] * 2)
    elif case == "single_cone":
        proj = lorentz_cone(1.0, torch.float64)
    elif case == "mu_dtype":
        proj = cone(torch.float32)
    elif case == "trace":
        cfg = dataclasses.replace(cfg, trace_len=4)
    elif case == "fixed_expansion":
        cfg, fixed = dataclasses.replace(cfg, expansion="fixed"), True
    return op, b, proj, cfg, fixed


@pytest.fixture
def looks_cuda(monkeypatch):
    """Every tensor answers ``is_cuda`` True: the predicate's other clauses
    are then what decides."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


REFUSED = ["cpu", "sharded", "own_dot", "box", "ball", "segment", "single_cone", "mu_dtype",
           "trace", "fixed_expansion"]
#: The cases that MPRGP's own clauses refuse; the rule it shares with
#: ``apgd.solve_sc`` (``step_common.fused_set_args``) refuses the rest.
MPRGP_ONLY = ["box", "fixed_expansion"]


@pytest.mark.parametrize("case", REFUSED)
def test_predicate_refuses_each_case(case, monkeypatch):
    op, b, proj, cfg, fixed = _dispatch_case(case)
    if case != "sharded":
        # On the CPU every case solves with the eager body ("fixed" is sound
        # on polyhedral sets only, so a cone lane may end at the budget).
        launches, it0 = mprgp_step.LAUNCHES, mprgp.MPRGP_ITERS
        r = mprgp.solve_bb(op, b, proj=proj if case != "mu_dtype" else cone(torch.float64),
                           config=cfg)
        assert bool(r.converged.any()) and mprgp.MPRGP_ITERS > it0
        assert mprgp_step.LAUNCHES == launches
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert mprgp._step_args(op, b, proj, cfg, fixed) is None
    shared = step_common.fused_set_args(op, b, proj, cfg.trace_len)
    assert (shared is None) == (case not in MPRGP_ONLY)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["shared_mu", "per_block_mu"])
def test_predicate_takes_lorentz_blocks(kind, dtype, looks_cuda):
    B, n = 3, 12
    b = torch.zeros((B, n), dtype=dtype)
    mu = torch.linspace(0.5, 2.0, n // 3, dtype=dtype) if kind == "per_block_mu" else None
    proj = cone(dtype, per_block=mu)
    op = DenseOperator(torch.eye(n, dtype=dtype).expand(B, n, n))
    for cfg in (MPRGPBBConfig(), MPRGPConfig()):
        sargs = mprgp._step_args(op, b, proj, cfg, False)
        assert (sargs.kind, sargs.s0, sargs.d) == ("lorentz", int(mu is not None), 3)
        assert sargs.p0 is proj.child.mu
        assert sargs == step_common.fused_set_args(op, b, proj, cfg.trace_len)
    # b that is not contiguous keeps the eager body.
    assert mprgp._step_args(op, torch.zeros((n, B), dtype=dtype).T, proj, cfg, False) is None


class _Swept(LinearOperator):
    """The operator of one pass of the eager body, whose one sweep is the
    given ``A v`` (f64): it records the operand the body swept."""

    def __init__(self, av):
        self.av, self.seen = av, None

    def matvec(self, x):
        self.seen = x
        return self.av

    def matvec_f64(self, x):
        return self.matvec(x)


def plain_operand(proj, s, gamma2):
    """(psi, prop, v): the eager body's free part of (x, g), proportioning
    test and operand for every lane, v in f64; a done lane's v is its x."""
    op = LinearOperator()
    psi, beta = proj.free_chopped(s.x, s.g)
    prop = op.dot(beta, beta) < gamma2 * op.dot(psi, psi)
    x_prop = proj.project(s.x - s.alpha_bb[:, None] * s.g)
    v = where_lanes(s.pending | s.verifying, s.x, where_lanes(prop, s.p, x_prop))
    return psi, prop, where_lanes(s.done, s.x, v).double()


def plain_pass(proj, config, av, b, s):
    """One eager pass on the sweep ``av`` with the select of the running
    lanes, and the operand the body swept."""
    op = _Swept(av)
    new = select_lanes(~s.done, mprgp._fused_body(s, op, b, proj, config), s)
    return new, op.seen


def _kernel_set(sargs):
    """The set a launch of the kernel reads: Lorentz blocks of ``sargs.d``
    with the tensor ``sargs.p0`` as mu (one, or one a block)."""
    return blockwise(LorentzConeProj(sargs.p0), sargs.d, child_axes=0 if sargs.s0 else None)


def _plain_kernel(calls):
    """``mprgp_step.step`` and ``operand`` as their plain version, for the
    CPU: the kernel's argument checks, then the eager body in place on the
    set the launch is given (the operand it sweeps must be the ``v`` the
    last call left, on every running lane), then the next operand; each
    call is counted as the wrapper counts a launch."""
    def check(b, s, psi, v, prop, av=None):
        mprgp_step._check(b, (b, s.x, s.g, s.p, s.x_prev, s.g_prev, psi),
                          (v,) if av is None else (av, v), (s.alpha_bb, s.res), (s.mv, s.it),
                          (s.done, s.pending, s.verifying, prop))

    def fill(proj, s, psi, v, prop, gamma2):
        # The running lanes' psi first: a loop's first launch writes it into
        # p, which the operand reads.
        psi_new, prop_new, _ = plain_operand(proj, s, gamma2)
        psi.copy_(where_lanes(s.done, psi, psi_new))
        prop.copy_(prop_new)
        v.copy_(plain_operand(proj, s, gamma2)[2])

    def operand(sargs, b, s, psi, v, prop, *, gamma2):
        check(b, s, psi, v, prop)
        calls.append("operand")
        kernels.count(mprgp_step._count)
        fill(_kernel_set(sargs), s, psi, v, prop, gamma2)

    def step(sargs, av, b, s, psi, v, prop, *, tol, budget, gamma2, tiny):
        check(b, s, psi, v, prop, av)
        calls.append("step")
        kernels.count(mprgp_step._count)
        cfg = MPRGPBBConfig(tol=tol, max_matvecs=budget, gamma=gamma2**0.5)
        proj = _kernel_set(sargs)
        new, seen = plain_pass(proj, cfg, av, b, s)
        run = ~s.done
        assert torch.equal(seen.double()[run], v[run])
        for t, t_new in zip(s[:-1], new[:-1]):
            t.copy_(t_new)
        fill(proj, s, psi, v, prop, gamma2)
    return operand, step


LOOP_CASES = ["shared_mu_f64", "per_block_mu_f64", "shared_mu_f32", "mprgp_f64"]


def _loop_case(case):
    """(A, b, a second b, x0, proj, config, solve) of a small problem for each
    case of the whole-loop tests."""
    dtype = torch.float32 if case.endswith("f32") else torch.float64
    tol = 1e-5 if dtype == torch.float32 else 1e-8
    A, b = problem(30, 4, 23, dtype)
    b2 = b + 1e-3 * torch.randn(b.shape, generator=torch.Generator().manual_seed(3),
                                dtype=torch.float64).to(dtype)
    mu = torch.linspace(0.5, 2.0, 10) if case.startswith("per_block") else None
    proj = cone(dtype, per_block=mu)
    x0 = proj.project(-b / A.diagonal(dim1=-2, dim2=-1))
    cfg = (MPRGPConfig if case.startswith("mprgp") else MPRGPBBConfig)(tol=tol,
                                                                        max_matvecs=400)
    solve = mprgp.solve if case.startswith("mprgp") else mprgp.solve_bb
    return A, b, b2, x0, proj, cfg, solve


def _eager_capture(calls):
    """``mprgp._capture`` on the CPU: the capture runs ``run()`` once, its
    launches neither counted nor in ``calls``, as a capture records them; a
    replay runs it eagerly (its launches counted as it runs)."""
    def capture(run, device):
        n = len(calls)
        with kernels.graph_capture():
            run()
        del calls[n:]
        return run
    return capture


def _loop_counters():
    return (mprgp.MPRGP_ITERS, mprgp_step.LAUNCHES, mprgp.MPRGP_CACHED_LOOPS,
            mprgp.MPRGP_GRAPH_CAPTURES, base.HOST_SYNCS)


@pytest.mark.parametrize("case", LOOP_CASES)
def test_fused_loop_on_the_plain_step_is_the_eager_solve(case, monkeypatch):
    """The fused loop with the step kernel from cached graphs
    (``_cached_solve``), its kernel stood in for by the plain step and its
    graphs' replays by eager runs of what they capture, against the eager
    loop: the same answers bitwise.  The first call misses the cache (it
    runs eagerly, then captures); a second on another b hits and replays,
    and so does a third on a new set whose mu is another (the loop solves
    on its own copy of the set, which each call refreshes).  Each call
    launches one step a pass and one operand launch a loop (``MPRGP_ITERS``
    is the passes) and reads a flag a pass and, where it is audited, two a
    loop, as the eager loop does."""
    A, b, b2, x0, proj, cfg, solve = _loop_case(case)
    mu2 = 1.25 * proj.child.mu
    proj2 = blockwise(LorentzConeProj(mu2), 3, child_axes=0 if mu2.dim() else None)
    cases = [(b, proj), (b2, proj), (b, proj2)]
    want = [solve(A, rhs, x0, p, cfg) for rhs, p in cases]

    calls = []
    operand, step = _plain_kernel(calls)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(mprgp_step, "operand", operand)
    monkeypatch.setattr(mprgp_step, "step", step)
    monkeypatch.setattr(mprgp, "_LOOPS", {})
    monkeypatch.setattr(mprgp, "_MISSED", {})
    monkeypatch.setattr(mprgp, "_capture", _eager_capture(calls))
    for k, ((rhs, p), w) in enumerate(zip(cases, want)):
        calls.clear()
        c0 = _loop_counters()
        got = solve(A, rhs, x0, p, cfg)
        passes, steps, loops, captures, syncs = (c - c_0 for c, c_0 in
                                                  zip(_loop_counters(), c0))
        assert passes == int(got.iterations.max()) > 3 and bool(got.converged.all())
        assert calls.count("step") == passes and calls[0] == "operand"
        operands = calls.count("operand")
        # One operand launch a loop: one loop in f64, one more a resumed audit
        # in f32.
        assert operands >= 1 and (b.dtype == torch.float32 or operands == 1)
        assert steps == passes + operands
        assert syncs == passes + (2 if b.dtype == torch.float32 else 1) * operands
        assert (loops, captures) == ((0, 1) if k == 0 else (operands, 0))
        for name in ("x", "residual", "matvecs", "iterations", "converged"):
            assert torch.equal(getattr(got, name), getattr(w, name)), name
    # A later call leaves an earlier answer as it was.
    first = solve(A, b, x0, proj, cfg)
    x = first.x.clone()
    solve(A, b2, x0, proj, cfg)
    assert torch.equal(first.x, x) and torch.equal(x, want[0].x)


@pytest.mark.parametrize("case", LOOP_CASES)
def test_stepped_loop_on_the_plain_step_is_the_eager_solve(case, monkeypatch):
    """Where the loop does not run from cached graphs (``_cached_loop`` gives
    None: a shape met once while another's graphs are kept, or an operator
    whose sweeps are its own), the fused loop with the step kernel
    replays a graph of a pass after its first, each pass's flag read on the
    host.  Its kernel stood in for by the plain step and its graph's replays
    by the eager loop, it gives the eager solve bitwise: one operand launch
    a loop and one step a pass."""
    A, b, _, x0, proj, cfg, solve = _loop_case(case)
    want = solve(A, b, x0, proj, cfg)

    calls = []
    operand, step = _plain_kernel(calls)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(mprgp_step, "operand", operand)
    monkeypatch.setattr(mprgp_step, "step", step)
    monkeypatch.setattr(mprgp, "_cached_loop", lambda *args: None)
    monkeypatch.setattr(mprgp, "_replay", lambda step_, s: mprgp._fused_loop(step_, s, False))
    it0 = mprgp.MPRGP_ITERS
    got = solve(A, b, x0, proj, cfg)
    passes = mprgp.MPRGP_ITERS - it0
    assert passes == int(got.iterations.max()) > 3 and bool(got.converged.all())
    assert calls.count("step") == passes and calls[0] == "operand"
    assert calls.count("operand") >= 1 and (b.dtype == torch.float32 or
                                             calls.count("operand") == 1)
    for name in ("x", "residual", "matvecs", "iterations", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


#: Sequences of solves and what each must run: "capture" (eagerly, then a
#: capture that takes the device's place), "hit" (a replay of the kept
#: graphs) or "stepped" (``_stepped_loop``, its graph the call's own).
#: "k1" is one solve shape on one stack; "k2" another shape on that stack
#: (another tol); "t" a shape on a stack made for the call, as phase 2 of a
#: compacted call has; "k1_dead" the shape of k1 on a new stack once the
#: first is gone.
CAPTURE_RULES = {
    "compacted": [("k1", "capture"), ("t", "stepped"), ("k1", "hit"), ("t", "stepped"),
                  ("k1", "hit")],
    "repeats": [("k1", "capture"), ("k2", "stepped"), ("k2", "capture"), ("k2", "hit"),
                ("k1", "stepped")],
    "alternates": [("k1", "capture"), ("k2", "stepped"), ("k1", "hit"), ("k2", "stepped"),
                   ("k1", "hit"), ("k2", "stepped")],
    "stack_gone": [("k1", "capture"), ("k1_dead", "capture"), ("k1_dead", "hit")],
    "compacted_behind_another": [("k2", "capture"), ("k1", "stepped"), ("t", "stepped"),
                                 ("k1", "capture"), ("t", "stepped"), ("k1", "hit")],
}


@pytest.mark.parametrize("rule", sorted(CAPTURE_RULES))
def test_graphs_are_captured_for_shapes_that_repeat(rule, monkeypatch):
    """``_cached_loop``'s rule over a sequence of solves, each run whole with
    the kernel stood in for by the plain step and the graphs by eager runs:
    a shape captures where no live loop is kept, or where it repeats a miss
    on the same stack with no hit between; a shape met once runs
    ``_stepped_loop`` and leaves the kept graphs in place.  Every answer is
    the eager solve's bitwise, and each outcome shows in the counters."""
    A, b, _, x0, proj, cfg, solve = _loop_case("shared_mu_f32")
    cfgs = {"k2": dataclasses.replace(cfg, tol=2 * cfg.tol)}
    rows = {"t": 2}
    want = {name: solve(A[:rows.get(name, len(b))], b[:rows.get(name, len(b))],
                        x0[:rows.get(name, len(b))], proj, cfgs.get(name, cfg))
            for name in ("k1", "k2", "t")}
    want["k1_dead"] = want["k1"]
    stacks = {}

    def stack(name):
        """k1 and k2 on one stack; t on one made for the call; k1_dead on a
        second stack, once the first is gone (equal values throughout)."""
        if name == "t":
            return A[:2].clone()
        if name == "k1_dead":
            stacks.pop("first", None)
            return stacks.setdefault("second", A.clone())
        return stacks.setdefault("first", A.clone())

    calls, stepped = [], []
    operand, step = _plain_kernel(calls)

    def replay(step_, s):
        stepped.append(s)
        return mprgp._fused_loop(step_, s, False)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(mprgp_step, "operand", operand)
    monkeypatch.setattr(mprgp_step, "step", step)
    monkeypatch.setattr(mprgp, "_LOOPS", {})
    monkeypatch.setattr(mprgp, "_MISSED", {})
    monkeypatch.setattr(mprgp, "_capture", _eager_capture(calls))
    monkeypatch.setattr(mprgp, "_replay", replay)
    for k, (name, outcome) in enumerate(CAPTURE_RULES[rule]):
        m = rows.get(name, len(b))
        c0, n_stepped = _loop_counters(), len(stepped)
        got = solve(stack(name), b[:m], x0[:m], proj, cfgs.get(name, cfg))
        _, _, loops, captures, _ = (c - c_0 for c, c_0 in zip(_loop_counters(), c0))
        ran = ("capture" if captures else "hit" if loops else
               "stepped" if len(stepped) > n_stepped else "none")
        assert (ran, captures) == (outcome, int(outcome == "capture")), (k, name)
        for field in ("x", "residual", "matvecs", "iterations", "converged"):
            assert torch.equal(getattr(got, field), getattr(want[name], field)), (k, field)


KEY_CHANGES = ["same", "mu", "mu_in_place", "A_in_place", "B", "n", "mu_layout", "tol",
               "budget", "x0"]
#: Changes the cached graphs serve: b, x0 and mu are copied in at each call.
KEY_HITS = ["same", "mu", "mu_in_place"]


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_a_change_of_what_the_graphs_read_misses_the_cache(change):
    """``graph_key`` of a solve against that of the same solve after one
    change: every change of what the cached graphs read by pointer or bake
    in (the stack A, its version, B, n, the layout of the set's mu, the
    config, whether x0 is given) gives another key, a recapture; equal
    inputs, and a set whose mu is another (its values are copied in at each
    call), give the same."""
    B, n, dtype = 3, 12, torch.float32

    def key(A, b, x0, proj, cfg):
        return mprgp.graph_key(DenseOperator(A), b, x0, step_common.set_args(proj, b), cfg)

    A, b = problem(n, B, 5, dtype)
    proj, cfg = cone(dtype), MPRGPBBConfig(tol=1e-5, max_matvecs=400)
    x0 = proj.project(-b / A.diagonal(dim1=-2, dim2=-1))
    before = key(A, b, x0, proj, cfg)
    if change == "A_in_place":
        A.mul_(1.0)
    elif change in ("B", "n"):
        A, b = problem(n, B + 1, 5, dtype) if change == "B" else problem(n + 3, B, 5, dtype)
        x0 = proj.project(-b / A.diagonal(dim1=-2, dim2=-1))
    elif change == "mu":
        proj = blockwise(lorentz_cone(0.5, dtype=dtype), 3)
    elif change == "mu_in_place":
        proj.child.mu.fill_(0.5)
    elif change == "mu_layout":
        proj = cone(dtype, per_block=torch.full((n // 3,), 1.0))
    elif change == "tol":
        cfg = dataclasses.replace(cfg, tol=2e-5)
    elif change == "budget":
        cfg = dataclasses.replace(cfg, max_matvecs=500)
    elif change == "x0":
        x0 = None
    b = b + 1.0   # b's values are copied in at each call: never part of the key
    assert (key(A, b, x0, proj, cfg) == before) == (change in KEY_HITS)


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _step_case(dtype, dev, B=64, n=999, per_block=False, seed=17):
    """(A in f64, b, state, proj) with lanes in every branch, by lane % 8: 0
    done; 1 an expansion's finish owed (pending); 2 a claim's verification;
    3 and 7 CG (x inside every cone, g small, p its free part); 4 an
    expansion (x on the surfaces, g inward, p its free part plus an outward
    step, so that the feasible step is ~0); 5 and 6 proportioning (g pushes
    every block outward: the chopped part outweighs the free one).  The
    other lanes' blocks are inside, on the surface or at the apex by block.
    Lanes % 16 == 7 and 12 are one matvec short of the budget (50); each
    lane's g (and the fresh gradient its b gives) is scaled by its own
    decade in [1e-3, 10], so that the residuals spread and a tol between
    two of them splits the lanes."""
    d, nblk = 3, n // 3
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    mu = (0.5 + 1.5 * torch.rand(nblk, generator=gen, dtype=torch.float64) if per_block
          else torch.ones(nblk, dtype=torch.float64))
    proj64 = cone(torch.float64, per_block=mu if per_block else None)
    lane = torch.arange(B)
    kind = lane % 8
    u = rnd(B, nblk, 2)
    un = u.norm(dim=-1)
    blk = torch.arange(nblk).expand(B, nblk)
    inside = (kind[:, None] == 3) | (kind[:, None] == 7) | \
        ((kind[:, None] <= 2) & (blk % 3 == 0))
    apex = (kind[:, None] <= 2) & (blk % 3 == 2)
    z = torch.where(inside, un / mu + 0.5, un / mu)
    x = proj64.project(torch.where(apex[..., None], 0.0, torch.cat([u, z[..., None]], -1))
                       .flatten(-2))
    normal = proj64.normal(x).unflatten(-1, (nblk, d))
    tangent = rnd(B, nblk, d)
    tangent = tangent - (tangent * normal).sum(-1, keepdim=True) * normal
    g = rnd(B, nblk, d)
    g = torch.where((kind == 4)[:, None, None], 0.3 * tangent - normal, g)
    g = torch.where(((kind == 5) | (kind == 6))[:, None, None], 5 * normal + 0.1 * tangent, g)
    g = torch.where(((kind == 3) | (kind == 7))[:, None, None], 1e-2 * g, g)
    scale = 10 ** (4 * torch.rand(B, generator=gen, dtype=torch.float64) - 3)
    g = (scale[:, None, None] * g).flatten(-2)
    psi, _ = proj64.free_chopped(x, g)
    p = rnd(B, n)
    p = torch.where(((kind == 3) | (kind == 7))[:, None], psi, p)
    p = torch.where((kind == 4)[:, None], psi - 0.3 * normal.flatten(-2) * scale[:, None], p)
    budget = 50
    s = mprgp._FusedState(
        x=x, g=g, p=p, x_prev=x + 0.1 * rnd(B, n), g_prev=g + 0.1 * scale[:, None] * rnd(B, n),
        alpha_bb=(0.5 + 1.5 * torch.rand(B, generator=gen, dtype=torch.float64)) / n,
        pending=kind == 1, verifying=kind == 2, res=torch.rand(B, generator=gen,
                                                              dtype=torch.float64),
        mv=torch.where((lane % 16 == 7) | (lane % 16 == 12), budget - 1,
                       lane % 7 + 3).to(torch.int32),
        it=(lane % 5 + 2).to(torch.int32), done=kind == 0,
        trace=torch.zeros((B, 0), dtype=torch.float64))
    # b puts the fresh gradient of a finish (at x) and of proportioning (at
    # P(x - alpha_bb g)) at the lane's scale, so that those lanes' residuals
    # spread too.
    A, _ = problem(n, B, seed, torch.float64, dev)
    x_prop = proj64.project(s.x - s.alpha_bb[:, None] * s.g)
    w = torch.where(((kind == 5) | (kind == 6))[:, None], x_prop, s.x).to(dev)
    b = (1e-3 * scale[:, None] * rnd(B, n)).to(dev) - (A @ w[..., None])[..., 0]
    s = mprgp._FusedState(*(t.to(device=dev, dtype=dtype) if t.is_floating_point()
                            else t.to(dev) for t in s))
    return A, b.to(dtype), s, cone(dtype, dev, mu if per_block else None), budget


def _branches(proj, s, av, gamma2):
    """Each lane's branch as the eager body takes it: (fin, cg, ex, pp)."""
    op = LinearOperator()
    tiny = base.eps_of(s.x)
    psi, prop, _ = plain_operand(proj, s, gamma2)
    pAp = op.dot(s.p, av.to(s.x.dtype)) + tiny
    take = op.dot(psi, s.p) / pAp <= proj.max_feasible_step(s.x, s.p)
    fin = s.pending | s.verifying
    return fin, ~fin & prop & take, ~fin & prop & ~take, ~fin & ~prop


def _both(A, b, s, proj, cfg):
    """The plain and the fused pass from state ``s``: (eager new state, its
    next (psi, prop, v); the fused state, its psi, prop, v; the branches;
    the sweep; the eager pass's own operand), the sweep ``A v`` taken by
    f64 products on the fused operand."""
    gamma2 = cfg.gamma**2
    f = mprgp._FusedState(*(t.clone() for t in s))
    psi = torch.empty_like(f.x)
    v = torch.empty(f.x.shape, dtype=torch.float64, device=f.x.device)
    prop = torch.empty_like(f.done)
    sargs = step_common.set_args(proj, b)
    mprgp_step.operand(sargs, b, f, psi, v, prop, gamma2=gamma2)
    av = (A @ v[..., None])[..., 0]
    ref, seen = plain_pass(proj, cfg, av, b, s)
    branches = _branches(proj, s, av, gamma2)
    av0, swept = av.clone(), v.clone()
    mprgp_step.step(sargs, av, b, f, psi, v, prop, tol=cfg.tol, budget=cfg.max_matvecs,
                    gamma2=gamma2, tiny=base.eps_of(b))
    assert torch.equal(av, av0)
    return ref, plain_operand(proj, ref, gamma2), (f, psi, prop, v), branches, seen, swept


def check_step(A, b, s, proj, budget):
    """One fused step against the eager body and its select (see
    ``test_fused_step_matches_the_eager_body``); returns the tol used."""
    dtype = b.dtype
    cfg = MPRGPBBConfig(tol=1.0, max_matvecs=budget)
    ref = _both(A, b, s, proj, cfg)[0]
    # The new residuals do not depend on tol: put tol in the widest gap
    # between two of them near the median of the lanes that report theirs.
    fin, cg, ex, pp = _both(A, b, s, proj, cfg)[3]
    res = ref.res[~s.done & ~ex].sort().values
    mid = len(res) // 2
    k = max(range(mid - 4, mid + 4), key=lambda i: float(res[i + 1] / res[i]))
    assert float(res[k + 1] / res[k]) > 1.01
    cfg = dataclasses.replace(cfg, tol=float(torch.sqrt(res[k] * res[k + 1])))
    ref, (psi_r, prop_r, v_r), (f, psi, prop, v), (fin, cg, ex, pp), seen, v0 = \
        _both(A, b, s, proj, cfg)
    run = ~s.done
    eps = torch.finfo(dtype).eps

    def close(got, want, what, *terms, spread=0.0):
        """Within 4 ulps of the largest entry of ``want`` and of ``terms``,
        what it is formed from, beyond ``spread`` (B,) per lane: the new g is
        the old one less a step along A p, psi is g less its normal part (so
        p and psi are held at the old and new g's scale too), and the
        operand v is x, p or a step from x (held at x's and g's)."""
        err = float(((got.double() - want.double()).abs().amax(-1) - spread).max())
        scale = max(float(t.double().abs().max()) for t in (want, *terms))
        assert err <= 4 * eps * scale, (what, err, scale)

    # Every branch is taken on some lane, and each way out of it.
    assert bool((run & fin & ref.done).any()) and bool((run & fin & ~ref.done).any())
    assert bool((run & cg & ref.verifying).any()) and bool((run & cg & ~ref.verifying).any())
    assert bool((run & ex & ref.pending).any()) and bool((run & ex & ref.done).any())
    assert bool((run & pp & ref.done & (ref.mv < budget)).any())
    assert bool((run & pp & ~ref.done).any())
    # Lanes that were done: every field bitwise as it was.
    for name, a, was in zip(mprgp._FusedState._fields, f, s):
        assert torch.equal(a[s.done], was[s.done]), name
    # The flags and counts exactly; vectors to rounding; res to its sum's order.
    for name in ("mv", "it", "done", "pending", "verifying"):
        assert torch.equal(getattr(f, name), getattr(ref, name)), name
    for name in ("x", "g", "p", "x_prev", "g_prev"):
        terms = (s.g[run], ref.g[run]) if name == "p" else ()
        close(getattr(f, name)[run], getattr(ref, name)[run], name, getattr(s, name)[run],
              *terms)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    # res past rtol by no more than 4 ulps of g's scale in each entry of the
    # residual vector move it.
    n = b.shape[1]
    slack = 4 * eps * s.g.abs().amax(-1).maximum(ref.g.abs().amax(-1)) / (3 * n**0.5)
    assert float(((f.res - ref.res).abs() - slack)[run].div(ref.res[run]).max()) <= rtol
    torch.testing.assert_close(f.alpha_bb, ref.alpha_bb, rtol=100 * rtol, atol=0)
    # The operand swept was the eager body's; the next one is too.
    close(seen.double()[run], v0[run], "v swept", s.x[run])
    live = ~ref.done
    assert torch.equal(prop[live], prop_r[live])
    close(psi[live], psi_r[live], "psi", ref.g[live], s.g[live])
    # P(x - alpha_bb g) moves by no more than alpha_bb g does: the part of
    # the difference that alpha_bb's (a quotient of two dots) accounts for
    # is allowed.
    spread = ((f.alpha_bb - ref.alpha_bb).abs() * ref.g.abs().amax(-1)).double()
    close(v[live], v_r[live], "v", ref.x[live], s.x[live], ref.g[live], s.g[live],
          spread=spread[live])
    return cfg.tol


@pytest.mark.cuda
@pytest.mark.parametrize("per_block", [False, True], ids=["shared_mu", "per_block_mu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fused_step_matches_the_eager_body(cuda, dtype, per_block):
    """One operand launch and one step from one state against the eager body
    with its select, on the same sweep: lanes in every branch (a finish, a
    verification, CG, an expansion, proportioning, done, the budget edge),
    tol in the widest gap between two new residuals.  The flags, mv and it
    equal; done lanes bitwise kept; x, g, p, x_prev, g_prev and v within 4
    ulps of the largest entry of what each is formed from (``check_step``);
    res within 1e-5 relative in f32 (beyond 4 ulps of g's scale in each
    entry of the residual vector), alpha_bb (a quotient of two dots, the
    secant pair's of which cancels) within 1e-3."""
    A, b, s, proj, budget = _step_case(dtype, cuda, per_block=per_block)
    before = mprgp_step.LAUNCHES
    check_step(A, b, s, proj, budget)
    torch.cuda.synchronize()
    assert mprgp_step.LAUNCHES > before


def _solve(A, b, tol, budget):
    """``solve_batched("mprgp_bb")`` on the dense stack from the cone-Jacobi
    start, as the benchmark's cell calls it."""
    op, proj = DenseOperator(A), cone(b.dtype, b.device)
    x0 = proj.project(-b / op.diagonal())
    return batch.solve_batched("mprgp_bb", op, b, x0=x0, proj=proj,
                               config=MPRGPBBConfig(tol=tol, max_matvecs=budget))


def _audited_under(A, b, r, tol):
    """Every lane converged and its x audits under tol in f64 from A and b
    (the check's audit)."""
    assert bool(r.converged.all())
    A64, x64 = A.double(), r.x.double()
    res = sets.pg_residual(SPEC, x64, reference.bmv(A64, x64) + b.double(), 1e-6)
    assert float(res.max()) < tol


@pytest.mark.cuda
def test_fused_solve_matches_the_eager_solve(cuda, monkeypatch):
    """Whole f32 solves at (64, 999), with the step kernel and with the eager
    loop on the same card: every lane converges, every claim audits under
    tol in f64, and the matvecs of the batch agree within 5%."""
    tol = 1e-5
    A, b = problem(999, 64, 999, torch.float32, cuda)
    launches, it0 = mprgp_step.LAUNCHES, mprgp.MPRGP_ITERS
    fused = _solve(A, b, tol, 20_000)
    torch.cuda.synchronize()
    assert mprgp_step.LAUNCHES - launches > mprgp.MPRGP_ITERS - it0
    monkeypatch.setattr(mprgp, "_step_args", lambda *args: None)
    launches = mprgp_step.LAUNCHES
    eager = _solve(A, b, tol, 20_000)
    assert mprgp_step.LAUNCHES == launches
    for r in (fused, eager):
        _audited_under(A, b, r, tol)
    ratio = fused.matvecs.sum().item() / eager.matvecs.sum().item()
    assert 0.95 <= ratio <= 1.05, ratio


@pytest.mark.cuda
def test_fused_solves_at_n9999_match_the_eager_solves(cuda, monkeypatch):
    """BASELINE #3's problem at B = 1 (n = 9999, the step on a cluster of
    eight blocks), twelve right-hand sides b0 + 1e-3 N(0, 1), as the
    benchmark's calls draw them.  Every solve converges and audits under
    tol, with the step kernel and with the eager loop.  A lane's pass count
    at this width moves by tens of percent under a perturbation of a last
    bit (the eager loop took 48 to 216 passes over such draws on an H100),
    so the matvecs are compared on the mean over the draws: the two means
    lie within three standard errors of their difference."""
    tol = 1e-5
    A, b0 = _big(cuda, 9999)
    gen = torch.Generator(device=cuda).manual_seed(5)
    step_args, counts = mprgp._step_args, {"fused": [], "eager": []}
    for _ in range(12):
        b = b0 + 1e-3 * torch.randn(b0.shape, generator=gen, device=cuda)
        for kind in counts:
            monkeypatch.setattr(mprgp, "_step_args",
                                step_args if kind == "fused" else lambda *args: None)
            launches = mprgp_step.LAUNCHES
            r = _solve(A, b, tol, 20_000)
            assert (mprgp_step.LAUNCHES > launches) == (kind == "fused")
            _audited_under(A, b, r, tol)
            counts[kind].append(float(r.matvecs[0]))
    f, e = (torch.tensor(counts[k], dtype=torch.float64) for k in ("fused", "eager"))
    se = float(torch.sqrt(f.var() / len(f) + e.var() / len(e)))
    assert abs(float(f.mean() - e.mean())) <= 3 * se, (counts, se)


def _big(dev, n):
    """BASELINE #3's problem at B = 1 on the card (as test_torch_mprgp_cone's
    n = 9999 test draws it)."""
    g = torch.Generator(device=dev).manual_seed(9999)
    G = torch.randn((1, n, n), generator=g, device=dev)
    A = torch.bmm(G, G.mT)
    del G
    A.diagonal(dim1=-2, dim2=-1).add_(n)
    xu = 2 * torch.rand((1, n), generator=g, device=dev) - 1
    return A, -torch.bmm(A, xu[..., None])[..., 0]


def _device_kernels(prof):
    """The names of the profiled device kernels (not copies or fills), in the
    order they ran."""
    from torch.autograd import DeviceType

    return [name for _, name in sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith(("Memcpy", "Memset")))]


@pytest.mark.cuda
def test_a_replayed_pass_launches_at_most_four_kernels(cuda, monkeypatch):
    """A pass from the cached graphs is the GEMV, the step and the loop's flag
    kernel: in the profiler's device events, at most two kernels lie
    between two steps of a call.  In f64, where no audit resumes the loop,
    the steps are the operand launch and one a pass."""
    monkeypatch.setattr(mprgp, "_LOOPS", {})
    monkeypatch.setattr(mprgp, "_MISSED", {})
    A, b = problem(999, 8, 5, torch.float64, cuda)
    _solve(A, b, 1e-8, 2000)                                  # warm-up: the capture
    torch.cuda.synchronize()
    it0, launches, loops = mprgp.MPRGP_ITERS, mprgp_step.LAUNCHES, mprgp.MPRGP_CACHED_LOOPS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _solve(A, b, 1e-8, 2000)
        torch.cuda.synchronize()
    passes = mprgp.MPRGP_ITERS - it0
    assert mprgp.MPRGP_CACHED_LOOPS - loops == 1
    assert passes > 3 and mprgp_step.LAUNCHES - launches == passes + 1
    names = _device_kernels(prof)
    steps = [i for i, name in enumerate(names) if "mprgp_step_kernel" in name]
    assert len(steps) == passes + 1
    gaps = [j - i - 1 for i, j in zip(steps[1:], steps[2:])]
    assert max(gaps) <= 2, [names[i:j] for i, j in zip(steps[1:], steps[2:]) if j - i > 3][:2]


@pytest.mark.cuda
def test_the_profiler_sees_every_launch_of_the_cached_graphs(cuda, monkeypatch):
    """In f32 at (8, 999), a call that replays the cached graphs: the
    profiler's (f32 A, f64 x) GEMV kernels are the ``gemv.LAUNCHES_F32_F64``
    gain, its step kernels the ``mprgp_step.LAUNCHES`` gain and its flag
    kernels the ``loop_flag.LAUNCHES`` gain, one a pass and two a loop (the
    loop's first and its audit's); the passes (``MPRGP_ITERS``) are the
    steps less one operand launch a loop, and the host reads a flag a pass
    and two a loop."""
    monkeypatch.setattr(mprgp, "_LOOPS", {})
    monkeypatch.setattr(mprgp, "_MISSED", {})
    A, b = problem(999, 8, 6, torch.float32, cuda)
    _solve(A, b, 1e-5, 20_000)                                # warm-up: the capture
    torch.cuda.synchronize()

    def counters():
        return (gemv.LAUNCHES_F32_F64, mprgp_step.LAUNCHES, loop_flag.LAUNCHES,
                mprgp.MPRGP_ITERS, mprgp.MPRGP_CACHED_LOOPS, mprgp.MPRGP_GRAPH_CAPTURES,
                base.HOST_SYNCS)

    c0 = counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        r = _solve(A, b, 1e-5, 20_000)
        torch.cuda.synchronize()
    sweeps, steps, flags, passes, loops, captures, syncs = (
        c - c_0 for c, c_0 in zip(counters(), c0))
    _audited_under(A, b, r, 1e-5)
    names = _device_kernels(prof)
    assert captures == 0 and loops >= 1 and syncs == passes + 2 * loops
    assert passes == int(r.iterations.max()) and steps == passes + loops
    assert flags == passes + 2 * loops
    assert sum("batched_gemv_kernel<float, double>" in name for name in names) == sweeps > 0
    assert sum("mprgp_step_kernel" in name for name in names) == steps
    assert sum("loop_flag_kernel" in name for name in names) == flags


@pytest.mark.cuda
def test_cached_graphs_give_the_replayed_loop_bitwise(cuda, monkeypatch):
    """Calls through the cached graphs against the loop that replays a graph
    of a pass after an eager first (``_stepped_loop``, taken where
    ``_cached_loop`` gives None), on the same inputs: x, the residual, the
    matvecs, the iterations and the flags bitwise.  Eight fresh b at
    (1, 9999) after the call that captures, then a (1024, 999) batch: met
    once while the n = 9999 graphs are kept, it runs ``_stepped_loop``;
    met again, it captures; then two hits, on b whose audits resume lanes
    on an H100 (a second loop in the last).  An earlier call's answer is
    left as it was by every later call."""
    tol, budget = 1e-5, 20_000
    monkeypatch.setattr(mprgp, "_LOOPS", {})
    monkeypatch.setattr(mprgp, "_MISSED", {})
    A, b0 = _big(cuda, 9999)
    A8, b8 = problem(999, 1024, 41, torch.float32, cuda)

    def fresh(b, gen):
        return b + 1e-3 * torch.randn(b.shape, generator=gen, device=cuda)

    gen, gen8 = (torch.Generator(device=cuda).manual_seed(17) for _ in range(2))
    calls = [(A, fresh(b0, gen)) for _ in range(9)] + [(A8, b8)] + \
        [(A8, fresh(b8, gen8)) for _ in range(3)]
    ran = {0: (1, False), 9: (0, False), 10: (1, False)}
    cached_loop, resumed, kept = mprgp._cached_loop, 0, None
    for k, (A_k, b) in enumerate(calls):
        monkeypatch.setattr(mprgp, "_cached_loop", cached_loop)
        c0 = (mprgp.MPRGP_CACHED_LOOPS, mprgp.MPRGP_GRAPH_CAPTURES)
        got = _solve(A_k, b, tol, budget)
        loops, captures = (c - c_0 for c, c_0 in
                           zip((mprgp.MPRGP_CACHED_LOOPS, mprgp.MPRGP_GRAPH_CAPTURES), c0))
        assert (captures, loops > 0) == ran.get(k, (0, True)), (k, captures, loops)
        resumed += loops > 1
        if k == 1:
            kept = (got, got.x.clone(), got.matvecs.clone())
        monkeypatch.setattr(mprgp, "_cached_loop", lambda *args: None)
        want = _solve(A_k, b, tol, budget)
        for name in ("x", "residual", "matvecs", "iterations", "converged"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (k, name)
        _audited_under(A_k, b, got, tol)
    assert resumed > 0
    assert torch.equal(kept[0].x, kept[1]) and torch.equal(kept[0].matvecs, kept[2])
