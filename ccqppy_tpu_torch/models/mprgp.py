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

**Below f64** (b in f32; a departure from the JAX package, which sums
each sweep in b's dtype).  A fresh gradient ``A x + b`` with f32 sums
carries the rounding of sums of size ``|A x|``, not of the gradient: at
n = 9999 (``A = G G^T + n I``, ``A x`` near 1e4) that moves the Eq. 25
residual (a norm over ``3 n``) by a few parts in 1e6, a third of tol
1e-5.  The loop claims a lane done on the first such reading under tol,
so its claims audited above tol in f64, and a lane that goes on iterates
around a point that the rounding, not the QP, fixes.  So below f64:

* every sweep sums in f64 (``LinearOperator.matvec_f64``; on the card the
  GEMV's (f32 A, f64 x) instance, at the f32 sweep's bytes) and is
  rounded once; a fresh gradient is ``A v + b`` in f64, rounded once;
* no lane is reported converged on a residual in b's dtype.  The unfused
  form's verification sweep, and in the fused form one sweep once every
  lane is done, is the f64 audit: ``A x + b`` and the residual in f64, on
  the set with its parameters in f64.  A lane whose audit is under tol
  is done with the audited residual; one whose audit is not goes on from
  x with the audited gradient, and the loop runs again.  The fused form's
  audit is counted in each claimed lane's matvecs (the unfused form's
  verification sweep was counted already).

In f64 the sweeps and the claims are the JAX package's.

**On the card** the fused loop on a dense stack replays a CUDA graph of a
pass after its first (``_replay``).  Where the set is a Lorentz cone over
blocks (one ``mu`` or one a block, in b's dtype;
``ops.step_common.set_args``'s "lorentz" kind), b is a contiguous f32 or
f64 tensor, the operator's reductions are ``LinearOperator``'s, the
expansion is "bb" and no trace is kept (``trace_len == 0``), a pass is the
sweep and one launch of the fused step kernel (``ops.mprgp_step``,
``csrc/mprgp_step.cu``), which computes the eager body and the select of
the running lanes in place and writes the next sweep's operand; one more
launch a loop puts the first operand in place.  Every other case, the CPU
included, runs the eager body, which is the kernel's plain version
(``_step_args`` decides, from the input alone: the rule
``ops.step_common.fused_set_args`` that ``apgd.solve_sc`` shares, and
MPRGP's own clauses).

With the step kernel, where the sweeps are ``DenseOperator``'s GEMV of its
stack (``_dense_sweeps``), a solve shape that repeats runs from CUDA
graphs kept across calls (``_cached_solve``, one solve shape a device):
the start, a pass (the sweep, the step and the loop's flag kernel,
``ops.loop_flag``), the audit and a resume, each a graph, captured after
a call of the shape has run them eagerly.  A call copies b, x0 and the
set's ``mu`` in, replays, and reads a flag on the host after each graph,
as the eager loop does; nothing else of the host's is left a pass.  The
same kernels run on the same values, so the answers are the eager loop's
bitwise.  A shape met once while another's graphs are kept (phase 2 of a
compacted call, on a new stack each call) runs ``_stepped_loop``, which
captures one graph of a pass for the call (``_cached_loop`` decides).

Telemetry: ``MPRGP_ITERS`` counts the loop's iterations on the host (a
pass of the body, every form), ``MPRGP_AUDITS`` the audit sweeps (a replay
of a captured one counts when it runs), ``MPRGP_CACHED_LOOPS`` the loops
run from cached graphs and ``MPRGP_GRAPH_CAPTURES`` their captures, and
the span ``ccqppy.mprgp.iter`` marks an iteration's host work under a
profiler (on the cached graphs a pass's replay); none of them reads the
device.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import weakref
from typing import NamedTuple

import torch

from ccqppy_tpu_torch.models.base import (SolverConfig, any_lane, default_x0,
                                          eps_of, host_flag, init_trace, lanes,
                                          make_result, pg_residual,
                                          record_trace, select_lanes, span,
                                          where_lanes)
from ccqppy_tpu_torch.ops import kernels, loop_flag, mprgp_step
from ccqppy_tpu_torch.ops.linop import DenseOperator, LinearOperator, as_operator
from ccqppy_tpu_torch.ops.projections import identity
from ccqppy_tpu_torch.ops.step_common import fused_set_args, set_args

#: Passes of either form's loop body in this process, counted on the host.
MPRGP_ITERS = 0
#: f64 audit sweeps (``LinearOperator.matvec_f64``) in this process: one a
#: batch each time they run, every lane swept.
MPRGP_AUDITS = 0
#: Loops run from cached graphs in this process (``_cached_solve``): a call's
#: first, and one more each time its audit resumes a lane.
MPRGP_CACHED_LOOPS = 0
#: Captures of those graphs in this process: misses of the cache where no
#: live loop is kept or the shape repeats (``_cached_loop``).
MPRGP_GRAPH_CAPTURES = 0


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


def _audited(b):
    """Whether the solve sums its sweeps and audits its claims in f64: b
    narrower than f64."""
    return b.dtype != torch.float64


def _matvec(op, v, b):
    """``A v`` in b's dtype; below f64 summed in f64 and rounded once."""
    if not _audited(b):
        return op.matvec(v)
    return op.matvec_f64(v).to(b.dtype)


def _sweep(op, v, b):
    """``(A v, A v + b)`` from one sweep; below f64 both from f64 sums, each
    rounded to b's dtype once, so a fresh gradient carries the rounding of
    its own size and not that of ``|A v|``."""
    if not _audited(b):
        Av = op.matvec(v)
        return Av, Av + b
    Av = op.matvec_f64(v)
    return Av.to(b.dtype), (Av + b.double()).to(b.dtype)


def _f64_set(proj):
    """The projection with its parameters in f64, for the audit: a copy,
    since ``.to`` converts a module in place.  (An f32 cone's normal, built
    from an f32 ``mu``, is off unit length by ~1e-8, and on blocks whose
    gradient is large that shows in the residual.)"""
    return copy.deepcopy(proj).to(torch.float64)


def _audit(op, proj64, b, x, gd):
    """The f64 audit of every lane's x: the gradient ``A x + b`` with f64
    sums from the operator's own entries, and its Eq. 25 residual on the
    f64 set ``proj64``, both f64."""
    kernels.count(_count_audit)
    g = op.matvec_f64(x) + b.double()
    return g, pg_residual(proj64, x.double(), g, gd, op)


def _count_audit():
    global MPRGP_AUDITS
    MPRGP_AUDITS += 1


def _count_pass():
    global MPRGP_ITERS
    MPRGP_ITERS += 1


def _iterate(step, active, s):
    """One pass ``step(s, active)`` on the lanes ``active``, counted and
    marked for the profiler."""
    global MPRGP_ITERS
    with span("ccqppy.mprgp.iter"):
        MPRGP_ITERS += 1
        return step(s, active)


def _selected(body):
    """A pass of the eager ``body`` on the lanes ``active`` (those not done
    when None): the rest keep their state."""
    return lambda s, active=None: select_lanes(~s.done if active is None else active,
                                               body(s), s)


def _graphed(op, b):
    """Whether the fused loop replays its passes as a CUDA graph: b on a card
    and a dense stack, whose sweeps are counted GEMV launches and whose
    reductions stay on the device (no collective)."""
    return b.is_cuda and isinstance(op, DenseOperator)


#: Per device: the memory pool of the loop's graphs and the last graph
#: captured in it.  The last graph is kept until the next is captured: it
#: keeps the pool alive (a pool whose graphs are all gone cannot take
#: another), and the next capture reuses its memory, since it is never
#: replayed again.
_GRAPH_POOLS = {}


def _fused_loop(step, s, graphed):
    """Pass ``step(s, active)`` over the lanes not done until every lane is
    done.  With ``graphed`` the first pass runs eagerly (it warms every
    kernel) and the rest replay one CUDA graph of a pass (``_replay``)."""
    while True:
        active = ~s.done
        if not any_lane(active):
            return s
        s = _iterate(step, active, s)
        if graphed:
            return _replay(step, s)


def _replay(step, s):
    """The rest of the loop from state ``s`` as replays of one CUDA graph of a
    pass, captured on the state (``_private``), which each replay updates in
    place: the same kernels on the same values as the eager passes,
    launched by the device, so a pass costs the host one launch and its
    flag's read (in place of ~600 launches for the eager body at B = 1, or
    of two for the fused step).  The GEMV's and the step kernel's counters
    count each replay's launches (``kernels.graph_capture``)."""
    global MPRGP_ITERS
    static = _private(s)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    pool, _ = _GRAPH_POOLS.get(s.x.device, (None, None))
    pool = torch.cuda.graph_pool_handle() if pool is None else pool
    with torch.cuda.stream(stream), kernels.graph_capture() as replayed:
        # Only this thread's calls are checked: a profiler's threads may
        # touch the card while a traced call captures.
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        new = step(static)
        for dst, src in zip(static, new):
            if dst is not src:
                dst.copy_(src)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    _GRAPH_POOLS[s.x.device] = (pool, graph)
    while any_lane(~static.done):
        with span("ccqppy.mprgp.iter"):
            MPRGP_ITERS += 1
            graph.replay()
            replayed()
    return static


def _private(s):
    """The state with every field a contiguous tensor of its own: a field
    that shares its storage with an earlier one (the first state's x and
    x_prev), or that is not contiguous, is copied."""
    seen, fields = set(), []
    for t in s:
        if t.data_ptr() in seen or not t.is_contiguous():
            t = t.clone(memory_format=torch.contiguous_format)
        seen.add(t.data_ptr())
        fields.append(t)
    return type(s)(*fields)


def _step_args(op, b, proj, config, fixed_exp):
    """``ops.step_common.fused_set_args`` of ``proj`` when the fused loop runs
    the step kernel (see the module docstring), else None: the eager body.
    MPRGP's own clauses: a graphed dense stack, the operator's own
    ``reduce_min``, the "bb" expansion and a Lorentz-block set."""
    if not _graphed(op, b) or fixed_exp or type(op).reduce_min is not LinearOperator.reduce_min:
        return None
    sargs = fused_set_args(op, b, proj, config.trace_len)
    return sargs if sargs is not None and sargs.kind == "lorentz" else None


def _stepped_loop(op, b, s, sargs, config):
    """The fused loop with the step kernel, on the state (``_private``),
    updated in place.  One launch puts the first operand in place; a pass is
    then the sweep of the operand ``v`` (f64) and the step, replayed as a
    CUDA graph after the first.  The pass leaves in ``psi`` and ``prop`` the
    free part of the new ``(x, g)`` and its proportioning test, which the
    next pass reads.  At a loop's start the direction of every running lane
    is the free part of (x, g) (the first state's, a resumed lane's): the
    first launch writes it into p, and psi is its copy.  Taken where no
    cached graphs serve the solve (``_cached_loop``): its graph is the
    call's own."""
    gamma2, tiny = config.gamma**2, eps_of(b)
    s = _private(s)
    v = torch.empty(s.x.shape, dtype=torch.float64, device=s.x.device)
    prop = torch.empty_like(s.done)
    mprgp_step.operand(sargs, b, s, s.p, v, prop, gamma2=gamma2)
    psi = s.p.clone()

    def step(s, active=None):
        mprgp_step.step(sargs, op.matvec_f64(v), b, s, psi, v, prop, tol=config.tol,
                        budget=config.max_matvecs, gamma2=gamma2, tiny=tiny)
        return s

    return _fused_loop(step, s, graphed=True)


def _dense_sweeps(op):
    """Whether the operator's sweeps are the GEMV of its own stack ``op.A``
    (``DenseOperator``'s matvecs), so that cached graphs read nothing else
    of it."""
    return (type(op).matvec is DenseOperator.matvec
            and type(op).matvec_exact is LinearOperator.matvec_exact
            and type(op).matvec_f64 is LinearOperator.matvec_f64)


def graph_key(op, b, x0, sargs, config):
    """The key of a solve's cached graphs (``_cached_solve``): everything they
    read by pointer or bake in.  b's device, shape and dtype; the operator's
    type and stack (identity, pointer, version); the set's kind, block size
    and the layout of its ``mu`` (one, or one a block); the config (tol,
    budget, gamma, gd and the rest); and whether x0 was given.  The values
    of b, x0 and mu are copied in at each call."""
    A = op.A
    return (b.device, tuple(b.shape), b.dtype, type(op), id(A), A.data_ptr(), A._version,
            tuple(A.shape), A.stride(), A.dtype, sargs.kind, tuple(sargs.p0.shape), sargs.s0,
            sargs.d, config, x0 is None)


#: Per device: the cached graphs of one solve shape (``_CachedLoop``).
_LOOPS = {}
#: Per device: the keys of the solves that missed the cache and did not
#: capture since its last hit or capture, the last ``_MISSES_KEPT`` of them,
#: each with a weak reference to its stack.
_MISSED = {}
_MISSES_KEPT = 4


def _cached_loop(op, b, x0, proj, sargs, config):
    """The loop of graphs that serves a solve that ``_step_args`` hands the
    step kernel (``_cached_solve``), or None where the solve should run
    ``_stepped_loop``.  The kept loop where the key is its (a hit); a new
    one, to capture, where no live loop is kept or where the key repeats a
    miss since the last hit, on the same stack; else None, and the miss is
    remembered.  So a shape met once (phase 2 of a compacted call, on a
    stack made for the call) neither captures nor evicts the kept loop,
    and a shape that alternates with the kept one does not capture."""
    if not _dense_sweeps(op):
        return None
    key, dev = graph_key(op, b, x0, sargs, config), b.device
    loop, missed = _LOOPS.get(dev), _MISSED.setdefault(dev, [])
    if loop is not None and loop.hit(key):
        missed.clear()
        return loop
    if (loop is None or loop.A_ref() is None
            or any(k == key and A() is op.A for k, A in missed)):
        missed.clear()
        return _CachedLoop(key, op, b, x0, proj, config)
    missed[:] = missed[1 - _MISSES_KEPT:] + [(key, weakref.ref(op.A))]
    return None


def _capture(run, device):
    """``run()`` captured as one CUDA graph in the device's pool of the loop's
    graphs.  Returns its replay, which launches the graph and counts the
    launches it records (``kernels.graph_capture``)."""
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    pool, _ = _GRAPH_POOLS.get(device, (None, None))
    pool = torch.cuda.graph_pool_handle() if pool is None else pool
    with torch.cuda.stream(stream), kernels.graph_capture() as replayed:
        # Only this thread's calls are checked: a profiler's threads may
        # touch the card while a traced call captures.
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            run()
        finally:
            # Closed also on an error: a capture left open fails every later
            # call of this thread.
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    _GRAPH_POOLS.setdefault(device, (pool, None))

    def replay():
        graph.replay()
        replayed()
    return replay


class _CachedLoop:
    """The fused loop with the step kernel for one solve shape, in four pieces
    that run on static buffers, in place: ``first`` (the start from b and
    x0, as ``_solve_fused`` starts, then the first operand), ``pass`` (the
    sweep of the operand and the step), ``audit`` (``_audit_fused``'s f64
    audit of the claims) and ``resume`` (the resumed lanes' gradient and
    direction, then the operand), as ``_stepped_loop`` and ``_audit_fused``
    run them: the same kernels on the same values.  ``first``, ``pass`` and
    ``resume`` end with the loop's flag (``ops.loop_flag``: "does a lane
    run?") and ``audit`` with "did the audit resume a lane?", each in the
    flags (two int64, in pinned host memory on a card), which the host
    reads.  A new loop runs the pieces eagerly, then captures each as a
    CUDA graph that later calls replay.  The buffers: copies of b and
    x0, the state, the step's psi, v and prop, the lanes that passed an
    audit, the audited gradient and the resumed lanes, and the loop's own
    copy of the set (its ``mu``), in b's dtype and in f64 for the audit.
    The operator's stack is read where it lies."""

    def __init__(self, key, op, b, x0, proj, config):
        B, n = b.shape
        dev, dt = b.device, b.dtype
        self.key, self.config = key, config
        self.op = None
        self.A_ref = weakref.ref(op.A)
        self.b = torch.empty_like(b, memory_format=torch.contiguous_format)
        self.x0 = None if x0 is None else torch.empty_like(self.b)
        vec, lane = (lambda dtype=dt: torch.empty((B, n), dtype=dtype, device=dev),
                     lambda dtype=dt: torch.empty(B, dtype=dtype, device=dev))
        self.s = _FusedState(x=vec(), g=vec(), p=vec(), x_prev=vec(), g_prev=vec(),
                             alpha_bb=lane(), pending=lane(torch.bool),
                             verifying=lane(torch.bool), res=lane(), mv=lane(torch.int32),
                             it=lane(torch.int32), done=lane(torch.bool),
                             trace=torch.empty((B, 0), dtype=dt, device=dev))
        self.psi, self.v, self.g_audit = vec(), vec(torch.float64), vec()
        self.prop, self.passed, self.resumed = lane(torch.bool), lane(torch.bool), \
            lane(torch.bool)
        # The two flags the host reads: in pinned host memory, which the flag
        # kernel writes through its mapped address, on a card; the host
        # writes and reads them through an array over the same memory.
        self.flags = torch.full((2,), -1, dtype=torch.int64, pin_memory=dev.type == "cuda")
        self.running, self.any_resumed = self.flags[0], self.flags[1]
        self.flag_values = self.flags.numpy()
        self.proj = copy.deepcopy(proj)
        self.sargs = set_args(self.proj, b)
        self.proj64 = _f64_set(proj) if _audited(b) else None
        self.graphs = None

    def hit(self, key):
        """Whether these graphs serve a solve of ``key``: the same key, and the
        operator's stack still the one captured (alive, so its id is its)."""
        return self.key == key and self.A_ref() is not None

    def load(self, op, b, x0, sargs):
        """A call's b, x0 and set (``sargs``' mu) into the loop's copies; its
        operator is held for the call (the graphs read its stack by pointer:
        it is not kept alive between calls)."""
        self.op = op
        self.b.copy_(b)
        if x0 is not None:
            self.x0.copy_(torch.as_tensor(x0))
        self.sargs.p0.copy_(sargs.p0)
        if self.proj64 is not None:
            self.proj64.child.mu.copy_(sargs.p0)

    def pieces(self):
        """The pieces as functions that run them eagerly; without an audit (b
        in f64) ``first`` and ``pass`` alone.  Made at each call: kept, they
        would hold the loop in a reference cycle, which the garbage collector
        may free, and its graphs with it, while another graph captures."""
        first = {"first": self._first, "pass": self._pass}
        return first if self.proj64 is None else {**first, "audit": self._audit,
                                                  "resume": self._resume}

    def _first(self):
        x_init = self.proj.project(default_x0(self.b, self.x0, self.proj))
        _copy(self.s, _fused_start(self.op, self.b, x_init, self.proj, self.config, free=False))
        self.passed.zero_()
        self._operand()

    def _operand(self):
        mprgp_step.operand(self.sargs, self.b, self.s, self.s.p, self.v, self.prop,
                           gamma2=self.config.gamma**2)
        self.psi.copy_(self.s.p)
        loop_flag.running(self.s.done, self.running)

    def _pass(self):
        c = self.config
        mprgp_step.step(self.sargs, self.op.matvec_f64(self.v), self.b, self.s, self.psi,
                        self.v, self.prop, tol=c.tol, budget=c.max_matvecs,
                        gamma2=c.gamma**2, tiny=eps_of(self.b))
        loop_flag.running(self.s.done, self.running)
        kernels.count(_count_pass)

    def _audit(self):
        s, resumed, passed, g64 = _audit_claims(self.op, self.proj64, self.b, self.s,
                                                self.config, self.passed)
        _copy(self.s, s)
        self.passed.copy_(passed)
        self.resumed.copy_(resumed)
        self.g_audit.copy_(g64)
        loop_flag.running(~resumed, self.any_resumed)

    def _resume(self):
        _copy(self.s, _resumed_state(self.proj, self.s, self.resumed, self.g_audit))
        self._operand()

    def solve(self, run):
        """One call's loops, each piece run by ``run[name]()``; the host reads
        the flag a piece writes after it, as the eager loop reads its own.
        Returns the number of loops."""
        values, dev = self.flag_values, self.b.device

        def flag(name, i):
            values[i] = -1
            run[name]()
            return host_flag(values, i, dev)

        running, loops = flag("first", 0), 1
        while True:
            while running:
                values[0] = -1
                with span("ccqppy.mprgp.iter"):
                    run["pass"]()
                running = host_flag(values, 0, dev)
            if self.proj64 is None or not flag("audit", 1):
                return loops
            running, loops = flag("resume", 0), loops + 1

    def capture(self):
        """Capture each piece as a CUDA graph (after an eager run has warmed
        every kernel)."""
        global MPRGP_GRAPH_CAPTURES
        MPRGP_GRAPH_CAPTURES += 1
        # No graph may be freed while one captures: collect what is garbage.
        gc.collect()
        self.graphs = {name: _capture(fn, self.b.device) for name, fn in self.pieces().items()}

    def result(self):
        """The answer as fresh tensors: a later call overwrites the state."""
        s = self.s
        return make_result(s.x.clone(), s.res.clone(), s.mv.clone(), s.it.clone(),
                           self.config.max_matvecs, s.trace.clone())


def _copy(dst, src):
    """Each field of the state ``src`` into the same field of ``dst``, in place
    (a field that is the same tensor is left)."""
    for d, t in zip(dst, src):
        if d is not t:
            d.copy_(t)


def _cached_solve(loop, op, b, x0, sargs):
    """The fused loop with the step kernel from the graphs of ``loop``
    (``_CachedLoop``, from ``_cached_loop``): a call copies b, x0 and the
    set's mu in and replays the graph of the start, then one of a pass
    while the flag says a lane runs, then the audit's (and the resume's,
    while it resumes a lane).  The same kernels run on the same values as
    in the eager loop, so the answers are its bitwise.  A new loop runs the
    call's pieces eagerly, which warms every kernel, then captures them for
    the next call and takes the device's place (the old graphs go after
    the capture: the pool keeps a graph)."""
    global MPRGP_CACHED_LOOPS
    loop.load(op, b, x0, sargs)
    try:
        if loop.graphs is not None:
            MPRGP_CACHED_LOOPS += loop.solve(loop.graphs)
            return loop.result()
        loop.solve(loop.pieces())
        result = loop.result()
        loop.capture()
        _LOOPS[b.device] = loop
        return result
    finally:
        loop.op = None


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


def _operands(A, b, proj):
    op = as_operator(A)
    proj = proj if proj is not None else identity()
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    return op, proj


def _prepare(A, b, x0, proj):
    op, proj = _operands(A, b, proj)
    return op, proj, proj.project(default_x0(b, x0, proj))


def _solve(A, b, x0, proj, config, bb_variant):
    """The three-branch form in nested verified loops."""
    op, proj, x_init = _prepare(A, b, x0, proj)
    tiny = eps_of(b)
    gamma2 = config.gamma**2
    budget, tol = config.max_matvecs, config.tol
    B = b.shape[0]
    fixed_exp = bb_variant and config.expansion == "fixed"
    alpha_bar = lanes(2.0 / op.inf_norm()) if fixed_exp else None

    _, g_init = _sweep(op, x_init, b)
    res0 = pg_residual(proj, x_init, g_init, config.gd, op)
    if bb_variant:
        alpha_bb0 = torch.zeros_like(res0)   # sentinel: seed on first use
        mv0 = 1
    else:
        # Seeded up front, one counted matvec (no tiny: as the JAX package).
        alpha_bb0 = op.dot(g_init, g_init) / op.dot(g_init, _matvec(op, g_init, b))
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
        Ap = _matvec(op, s.p, b)
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
        _, g_ex = _sweep(op, x_ex, b)
        psi_ex, _ = proj.free_chopped(x_ex, g_ex)
        a_ex = _bb_step(op, x_ex - s.x, g_ex - s.g, tiny)
        take_cg = alpha_cg <= alpha_f
        ce = (where_lanes(take_cg, x_cg, x_ex), where_lanes(take_cg, g_cg, g_ex),
              where_lanes(take_cg, p_cg, psi_ex), where_lanes(take_cg, a_cg, a_ex),
              where_lanes(take_cg, mv_ce, mv_ce + 1))

        # ---- proportioning: a BB-sized step along the full gradient ------
        if bb_variant:
            seed_needed = s.alpha_bb == 0
            a_seed = op.dot(s.g, s.g) / (op.dot(s.g, _matvec(op, s.g, b)) + tiny)
            a_hist = _bb_step(op, s.x - s.x_prev, s.g - s.g_prev, tiny)
            a_pp = torch.where(seed_needed, a_seed, a_hist)
            mv_pp = s.mv + seed_needed.to(torch.int32)
        else:
            a_pp, mv_pp = s.alpha_bb, s.mv
        x_pp = proj.project(s.x - lanes(a_pp) * s.g)
        _, g_pp = _sweep(op, x_pp, b)
        psi_pp, _ = proj.free_chopped(x_pp, g_pp)
        pp = (x_pp, g_pp, psi_pp, _bb_step(op, x_pp - s.x, g_pp - s.g, tiny), mv_pp + 1)

        x1, g1, p1, a_bb, mv = (where_lanes(proportional, c, q) for c, q in zip(ce, pp))
        res = pg_residual(proj, x1, g1, config.gd, op)
        # ``mv + 1``: one matvec of budget is reserved for the verification.
        done = (res < tol) | (mv + 1 >= budget)
        return _State(x1, g1, p1, a_bb, s.x, s.g, res, mv, s.it + 1, done,
                      record_trace(s.trace, s.it, res))

    proj64 = _f64_set(proj) if _audited(b) else None
    step = _selected(body)
    while True:
        outer = ~o.done
        if not any_lane(outer):
            break
        s = o
        while True:
            active = outer & ~s.done
            if not any_lane(active):
                break
            s = _iterate(step, active, s)
        # Verification sweep for every outer-active lane, with the exact
        # matvec (the JAX package uses op.matvec here; the two are the same
        # for every operator ported so far); below f64, the f64 audit.
        mv = s.mv + 1
        if proj64 is not None:
            g64, res64 = _audit(op, proj64, b, s.x, config.gd)
            g_t, res_t, passed = g64.to(b.dtype), res64.to(b.dtype), res64 < tol
        else:
            g_t = op.matvec_exact(s.x) + b
            res_t = pg_residual(proj, s.x, g_t, config.gd, op)
            passed = res_t < tol
        psi_t, _ = proj.free_chopped(s.x, g_t)
        done = passed | (mv >= budget)
        o = select_lanes(outer, _State(s.x, g_t, psi_t, s.alpha_bb, s.x_prev, s.g_prev,
                                  res_t, mv, s.it, done, s.trace), o)

    result = make_result(o.x, o.res, o.mv, o.it, budget, o.trace)
    # o.res is a fresh-gradient residual on every exit path (the audited one
    # below f64).
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


def _fused_body(s, op, b, proj, config, fixed_exp=False, alpha_bar=None):
    """One eager pass of the single-sweep loop on every lane (the caller
    keeps the done lanes' state): the plain version of ``ops.mprgp_step``.
    ``fixed_exp`` takes the "fixed" expansion with step ``alpha_bar``
    (B, 1)."""
    tiny, gamma2, tol, budget = eps_of(b), config.gamma**2, config.tol, config.max_matvecs
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
    Av, Avb = _sweep(op, v, b)                          # the one sweep
    mv = s.mv + 1

    # ---- expansion finish / claim verify: fresh g at x (Av == A x) ----
    g_fin = Avb
    a_fin = _bb_step(op, s.x - s.x_prev, g_fin - s.g_prev, tiny)
    # ---- proportioning: fresh gradient at x_prop (Av == A x_prop) -----
    g_pp = Avb
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


def _solve_fused(A, b, x0, proj, config, bb_variant):
    """Single-sweep MPRGP: one operator application per iteration, the
    branch chosen per lane by select.  Same iterates and matvec totals as
    the three-branch form, except that the BB seed ``g.g / g.Ag`` is spent
    at init (+1 matvec where the first proportioning step is away from the
    initial iterate) and an expansion's residual lands one iteration later.
    Below f64 every claim is audited once the loop ends (``_audit_fused``)."""
    op, proj = _operands(A, b, proj)
    fixed_exp = bb_variant and config.expansion == "fixed"
    sargs = _step_args(op, b, proj, config, fixed_exp)
    loop = None if sargs is None else _cached_loop(op, b, x0, proj, sargs, config)
    if loop is not None:
        return _cached_solve(loop, op, b, x0, sargs)
    x_init = proj.project(default_x0(b, x0, proj))
    alpha_bar = lanes(2.0 / op.inf_norm()) if fixed_exp else None
    s = _fused_start(op, b, x_init, proj, config, free=sargs is None)
    step = _selected(functools.partial(_fused_body, op=op, b=b, proj=proj, config=config,
                                       fixed_exp=fixed_exp, alpha_bar=alpha_bar))
    proj64, passed = (_f64_set(proj) if _audited(b) else None), torch.zeros_like(s.done)
    graphed = _graphed(op, b)
    while True:
        if sargs is not None:
            s = _stepped_loop(op, b, s, sargs, config)
        else:
            s = _fused_loop(step, s, graphed)
        if proj64 is None:
            break
        s, resumed, passed = _audit_fused(op, proj, proj64, b, s, config, passed)
        if resumed is None:
            break
    # Every converged exit carries a fresh-gradient residual (the audited one
    # below f64); budget exits are unconverged by the mv < max semantics.
    return make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)


def _fused_start(op, b, x_init, proj, config, free=True):
    """The single-sweep loop's first state from the feasible ``x_init``: two
    sweeps, the gradient and the BB seed ``g.g / g.Ag``.  The direction p is
    the free part of (x, g); without ``free`` it is left unset, for the step
    kernel's first launch to write (``_stepped_loop``)."""
    B, tiny = b.shape[0], eps_of(b)
    _, g_init = _sweep(op, x_init, b)
    res0 = pg_residual(proj, x_init, g_init, config.gd, op)
    alpha_bb0 = op.dot(g_init, g_init) / (op.dot(g_init, _matvec(op, g_init, b)) + tiny)
    psi0 = proj.free_chopped(x_init, g_init)[0] if free else torch.empty_like(g_init)
    false = torch.zeros(B, dtype=torch.bool, device=b.device)
    return _FusedState(x=x_init, g=g_init, p=psi0, x_prev=x_init, g_prev=g_init,
                       alpha_bb=alpha_bb0, pending=false, verifying=false, res=res0,
                       mv=torch.full((B,), 2, dtype=torch.int32, device=b.device),
                       it=torch.zeros(B, dtype=torch.int32, device=b.device),
                       done=(res0 < config.tol) | (2 >= config.max_matvecs),
                       trace=init_trace(config, B, b.dtype, b.device))


def _audit_fused(op, proj, proj64, b, s, config, passed):
    """Audit the fused loop's claims in f64, once every lane is done.  A
    claimed lane (done with its residual under tol and matvecs left, not
    ``passed`` an audit already) is charged the sweep and takes the audited
    residual; one whose audit is not under tol and that has matvecs left is
    resumed from x with the audited gradient in b's dtype and its free part
    as the direction.  Returns the state, the resumed lanes (None where no
    lane resumed: the state's g and p are then left as they are, since no
    lane runs on them) and the lanes that have passed an audit.  Whether
    any lane resumed is the audit's one read on the host."""
    s, resumed, passed, g64 = _audit_claims(op, proj64, b, s, config, passed)
    if not any_lane(resumed):
        return s, None, passed
    return _resumed_state(proj, s, resumed, g64.to(b.dtype)), resumed, passed


def _audit_claims(op, proj64, b, s, config, passed):
    """``_audit_fused`` up to its read: the state with the claims' audited
    residuals and matvecs, the lanes to resume, the lanes that have passed
    an audit, and the audited gradient in f64."""
    budget = config.max_matvecs
    claimed = s.done & ~passed & (s.res < config.tol) & (s.mv < budget)
    g64, res64 = _audit(op, proj64, b, s.x, config.gd)
    under = res64 < config.tol
    mv = s.mv + claimed.to(s.mv.dtype)
    resumed = claimed & ~under & (mv < budget)
    s = s._replace(res=where_lanes(claimed, res64.to(s.res.dtype), s.res), mv=mv)
    return s, resumed, passed | (claimed & under), g64


def _resumed_state(proj, s, resumed, g):
    """The lanes ``resumed`` go on from x with the audited gradient ``g`` (in
    b's dtype) and its free part as the direction."""
    psi, _ = proj.free_chopped(s.x, g)
    return s._replace(g=where_lanes(resumed, g, s.g), p=where_lanes(resumed, psi, s.p),
                      done=s.done & ~resumed)


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
