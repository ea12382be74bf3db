"""Roofline-guarded timing of batched solves, device-only kernel times, and
the random-ensemble benchmark harness.

Port of ``ccqppy_tpu/utils/benchmark.py``: ``materialize``, ``TimedRun``,
``timed_run``, ``dense_sweep_bytes``, and the harness ``BenchmarkResult``,
``BenchmarkRandomCCQP``, ``default_families`` and ``disjoint_families``.  PyTorch
launches CUDA work asynchronously, so the fence that closes a timed rep is
``torch.cuda.synchronize`` of every device the outputs live on; outputs
are then copied to the host and checked outside the clock.

``device_ms`` (no JAX counterpart) times one call's device work alone, for
kernels and the library calls they are held against.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import statistics
import time
from typing import Sequence

import numpy as np
import torch

from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch
from ccqppy_tpu_torch.utils.rng import split_keys

# H100 SXM device-memory peak (NVIDIA data sheet, 3.35 TB/s).  The guard
# rejects walls implying more than ``margin x`` this rate -- a measurement
# "faster than the memory system" is a leaked fence, not a fast program.
# The default margin of 2 also covers the other H100 forms.
PEAK_HBM_BYTES_PER_S = 3.35e12


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from _tensors(leaf)


def synchronize(tree):
    """Wait for the device work producing every CUDA tensor in ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def materialize(tree) -> float:
    """Copy every tensor of ``tree`` to the host and return a checksum."""
    total = 0.0
    for t in _tensors(tree):
        t = t.detach().cpu()
        if t.is_floating_point():
            total += float(torch.nansum(t.abs().to(torch.float64)))
        else:
            total += float(t.to(torch.int64).sum())
    return total


@dataclasses.dataclass
class TimedRun:
    """Result of a guarded timing measurement (``timed_run``)."""

    wall_s: float            # min credible wall over the accepted reps
    walls: list              # every accepted rep wall
    rejected: list           # walls rejected by the roofline guard
    result: object           # output of the final rep
    implied_bytes: float | None = None

    @property
    def implied_gbps(self):
        if self.implied_bytes is None:
            return None
        return self.implied_bytes / self.wall_s / 1e9


def timed_run(fn, *args, reps=3, implied_bytes=None,
              peak_bytes_per_s=PEAK_HBM_BYTES_PER_S, margin=2.0,
              make_args=None, warmup=True, check=None):
    """Roofline-guarded wall-clock measurement of ``fn(*args)``.

    1. **Fence.**  Inputs are synchronized before the clock starts; each rep
       ends with ``synchronize`` of its outputs inside the clock.  The
       outputs are then copied to the host outside the clock.
    2. **Roofline sanity.**  With ``implied_bytes`` (the device-memory
       traffic the computation must at least move), a rep whose wall implies
       more than ``margin x peak_bytes_per_s`` is measured again once and
       rejected if it persists; if every rep is rejected this raises.

    ``make_args(rep) -> tuple`` replaces ``args`` per rep.  ``warmup`` runs
    one untimed call first.  ``check(result)`` runs on every rep's output,
    outside the clock.  Returns a ``TimedRun`` whose ``wall_s`` is the min
    accepted wall.
    """
    if warmup:
        a = make_args(-1) if make_args is not None else args
        materialize(fn(*a))
    walls, rejected = [], []
    result = None
    floor = None
    if implied_bytes is not None:
        floor = float(implied_bytes) / (margin * peak_bytes_per_s)

    def one_rep(rep):
        a = make_args(rep) if make_args is not None else args
        synchronize(a)
        t0 = time.perf_counter()
        out = fn(*a)
        synchronize(out)
        wall = time.perf_counter() - t0
        materialize(out)
        if check is not None:
            check(out)
        return wall, out

    for rep in range(reps):
        wall, result = one_rep(rep)
        if floor is not None and wall < floor:
            wall2, result = one_rep(rep)
            if wall2 < floor:
                rejected.extend([wall, wall2])
                continue
            rejected.append(wall)
            wall = wall2
        walls.append(wall)
    if not walls:
        raise RuntimeError(
            f"timed_run: every rep implied > {margin:g}x the device-memory "
            f"roofline ({peak_bytes_per_s / 1e9:.0f} GB/s): walls {rejected} "
            f"vs credible floor {floor:.4g}s for {implied_bytes:.3g} bytes -- "
            "the timing fence is leaking; refusing to report")
    return TimedRun(wall_s=min(walls), walls=walls, rejected=rejected,
                    result=result, implied_bytes=implied_bytes)


def dense_sweep_bytes(batch, n, sweeps, dtype_bytes=4):
    """Device-memory bytes a batched dense solve must at least move:
    ``sweeps`` full reads of the (n, n) Hessian per lane."""
    return float(batch) * float(sweeps) * float(n) * float(n) * dtype_bytes


#: Least spin before a device-only rep's start event, in seconds.
MIN_SPIN_S = 1e-3
#: The spin is at least this many times the slowest host enqueue of ``fn``
#: seen in the warm-up.
SPIN_FACTOR = 10
#: Times in a row a rep may be taken again after its enqueue outlasted its
#: spin before ``device_ms`` raises.
HELD_RETRIES = 3


@functools.cache
def _spin_cycles_per_ms(device):
    """Clock cycles ``torch.cuda._sleep`` spins for in one ms on ``device``,
    measured once by CUDA events around a spin of 2e6 cycles."""
    with torch.cuda.device(device):
        torch.cuda._sleep(1000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(2_000_000)
        b.record()
        b.synchronize()
        return 2e6 / a.elapsed_time(b)


def _held_rep(fn, cycles):
    """One rep behind a spin of ``cycles``: (device ms of ``fn``, host ms
    from just before the spin's event to just after the end event, device
    ms of the spin)."""
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    held.record()
    torch.cuda._sleep(cycles)
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end), host_ms, held.elapsed_time(start)


def device_ms(fn, reps=25, warmup=3):
    """Median device time in ms of the work ``fn()`` enqueues on the
    current CUDA stream, without the host's time to enqueue it.

    A CUDA event recorded before ``fn()`` on an idle stream is stamped at
    once, so the card idles while the host runs the wrapper, and the
    reading would hold host time.  Here each rep first holds the stream
    with ``torch.cuda._sleep`` for a spin of ``SPIN_FACTOR`` times the
    slowest enqueue of ``fn`` in the warm-up (at least ``MIN_SPIN_S``),
    then records the start event, ``fn()`` and the end event behind it:
    the events bracket ``fn``'s device work alone.  Each rep checks that
    the host finished enqueueing (from just before the spin's own event to
    just after the end event) within the spin as the card timed it.  A rep
    that did not is a mixed reading and is never kept: it is taken again
    behind a spin twice as long, and ``HELD_RETRIES`` such reps in a row
    raise.  The garbage collector is off during the reps."""
    device = torch.cuda.current_device()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    cycles = int(max(SPIN_FACTOR * max(host), MIN_SPIN_S) * 1e3 * _spin_cycles_per_ms(device))
    times = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for _ in range(reps):
            for _ in range(HELD_RETRIES):
                ms, host_ms, spin_ms = _held_rep(fn, cycles)
                if host_ms < spin_ms:
                    times.append(ms)
                    break
                cycles *= 2
            else:
                raise RuntimeError(
                    f"device_ms: {HELD_RETRIES} reps in a row took the host longer to enqueue "
                    f"than the card held them (last {host_ms:.4f} ms against {spin_ms:.4f} ms): "
                    f"a reading would hold host time")
    finally:
        if collecting:
            gc.enable()
    return statistics.median(times)


@dataclasses.dataclass
class BenchmarkResult:
    """The harness's four result tensors, each [S, F, N, T] (solvers,
    projection families, sizes, trials)."""

    solver_names: list
    family_names: list
    sizes: list
    num_trials: int
    residual: np.ndarray    # [S, F, N, T]
    converged: np.ndarray
    solve_time: np.ndarray  # seconds per problem (batch wall / T)
    matvecs: np.ndarray

    def to_json(self, path=None):
        payload = {
            "solvers": self.solver_names,
            "families": self.family_names,
            "sizes": list(map(int, self.sizes)),
            "num_trials": self.num_trials,
            "residual": self.residual.tolist(),
            "converged": self.converged.tolist(),
            "solve_time": self.solve_time.tolist(),
            "matvecs": self.matvecs.tolist(),
        }
        text = json.dumps(payload)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def summary(self):
        lines = []
        for i, s in enumerate(self.solver_names):
            for j, f in enumerate(self.family_names):
                for k, n in enumerate(self.sizes):
                    lines.append(
                        f"{s:10s} {f:12s} n={n:<6d} "
                        f"conv={self.converged[i, j, k].mean():5.1%} "
                        f"mv={self.matvecs[i, j, k].mean():8.1f} "
                        f"t={self.solve_time[i, j, k].mean() * 1e3:8.3f} ms")
        return "\n".join(lines)

    def plot(self, metric="matvecs", **kw):
        from ccqppy_tpu_torch.utils.plotting import plot_benchmark_metric
        data = getattr(self, metric)
        return plot_benchmark_metric(metric, data, self.solver_names,
                                     self.family_names, self.sizes, **kw)


class BenchmarkRandomCCQP:
    """Batched random-Wishart CCQP benchmark: port of the JAX package's
    harness, each (solver, family, size) cell one ``solve_batched`` over
    all trials, timed by ``timed_run``.

    Parameters
    ----------
    num_random_trials: problems per (solver, family, size) cell, solved as
        one batch.
    solvers: list of solver names (keys of ``models.SOLVERS``).
    proj_factories: dict family-name -> callable(n, dtype) -> Projection,
        whose parameters lie on ``device``.
    sizes: problem dimensions.
    device: where the ensembles are drawn and solved.

    The ensembles come from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (``utils.random_qp.random_qp_batch``, one draw per size) and
    SPG's keys from ``utils.rng.split_keys(seed + 1, T)``: the same
    distributions as the JAX harness's ``jax.random`` draws, other numbers.
    """

    def __init__(self, num_random_trials, solvers: Sequence[str],
                 proj_factories: dict, sizes: Sequence[int],
                 tol=1e-5, max_matvecs=5000, dtype=torch.float32,
                 diag_boost=0.0, seed=0, *, device="cuda"):
        self.num_trials = int(num_random_trials)
        self.solver_names = list(solvers)
        self.proj_factories = dict(proj_factories)
        self.sizes = [int(s) for s in sizes]
        self.tol = tol
        self.max_matvecs = max_matvecs
        self.dtype = dtype
        self.diag_boost = diag_boost
        self.seed = seed
        self.device = torch.device(device)
        self.result: BenchmarkResult | None = None

    def run(self, verbose=True, check=None):
        """Solve every cell; returns (and keeps) the ``BenchmarkResult``.
        ``check(solver, family, n, result)``, if given, runs on the
        ``SolveResult`` of every timed rep, outside the clock."""
        # Imported here: models imports utils (for its keys), whose package
        # imports this module.
        from ccqppy_tpu_torch.models import SOLVERS
        from ccqppy_tpu_torch.parallel.batch import solve_batched

        S = len(self.solver_names)
        F = len(self.proj_factories)
        N = len(self.sizes)
        T = self.num_trials
        shape = (S, F, N, T)
        residual = np.zeros(shape)
        converged = np.zeros(shape, bool)
        solve_time = np.zeros(shape)
        matvecs = np.zeros(shape, np.int64)

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        for k, n in enumerate(self.sizes):
            As, bs, _ = random_qp_batch(gen, T, n, self.dtype, self.diag_boost)
            for j, (fam, factory) in enumerate(self.proj_factories.items()):
                proj = factory(n, self.dtype)
                buf = next(proj.buffers(), None)
                if buf is not None and buf.device != As.device:
                    raise ValueError(f"family {fam!r} built its set on {buf.device}, "
                                     f"the ensemble is on {As.device}")
                for i, sname in enumerate(self.solver_names):
                    fn, cfg_cls = SOLVERS[sname]
                    cfg = cfg_cls(tol=self.tol, max_matvecs=self.max_matvecs)
                    keys = split_keys(self.seed + 1, T, self.device) if sname == "spg" else None
                    # The warm run's matvec counts set a conservative
                    # roofline floor: half the known dense operator
                    # traffic; min of 2 reps.
                    r = solve_batched(fn, As, bs, proj=proj, config=cfg, keys=keys)
                    mv_total = int(r.matvecs.sum())
                    implied = 0.5 * mv_total * n * n * 4
                    cell_check = None if check is None else (
                        lambda r_, s=sname, f=fam, n_=n: check(s, f, n_, r_))
                    out = timed_run(
                        lambda: solve_batched(fn, As, bs, proj=proj, config=cfg, keys=keys),
                        reps=2, implied_bytes=implied, warmup=False, check=cell_check)
                    r = out.result
                    residual[i, j, k] = r.residual.double().cpu().numpy()
                    converged[i, j, k] = r.converged.cpu().numpy()
                    matvecs[i, j, k] = r.matvecs.cpu().numpy()
                    solve_time[i, j, k] = out.wall_s / T
                    if verbose:
                        print(f"[bench] {sname:10s} {fam:12s} n={n:<6d} "
                              f"conv={converged[i, j, k].mean():5.1%} "
                              f"mv={matvecs[i, j, k].mean():8.1f} "
                              f"{T / out.wall_s:10.1f} solves/s", flush=True)

        self.result = BenchmarkResult(self.solver_names,
                                      list(self.proj_factories), self.sizes,
                                      T, residual, converged, solve_time,
                                      matvecs)
        return self.result

    def process_results(self, save_prefix=None):
        """Reference parity: plot wall-time (log y), matvecs (log y),
        residual."""
        if self.result is None:
            raise RuntimeError("call run() first")
        figs = []
        for metric, logy in (("solve_time", True), ("matvecs", True),
                             ("residual", False)):
            path = f"{save_prefix}_{metric}.png" if save_prefix else None
            figs.append(self.result.plot(metric, do_log_y=logy,
                                         save_path=path))
        return figs


# Standard projection-family factories (the reference's entry points), each
# building its set in ``dtype`` on ``device``.
def default_families(dtype=torch.float32, device="cuda"):
    def _box(n, dt):
        return P.box(-torch.ones(n), torch.ones(n), dt, device)

    def _lower(n, dt):
        return P.lower_bound(-torch.ones(n), dt, device)

    def _upper(n, dt):
        return P.upper_bound(torch.ones(n), dt, device)

    def _ball(n, dt):
        return P.ball(1.0, dtype=dt, device=device)

    def _identity(n, dt):
        return P.identity()

    return {"identity": _identity, "lower": _lower, "upper": _upper,
            "ball": _ball, "box": _box}


def disjoint_families(block_dim=3, dtype=torch.float32, device="cuda"):
    """Blockwise (disjoint-union) families over ``block_dim``-sized blocks --
    the reference's contact-mechanics pattern, including the Lorentz
    cone."""
    def _wrap(child_fn):
        def f(n, dt):
            if n % block_dim:
                raise ValueError(f"n = {n} is not a multiple of the block size {block_dim}")
            return P.blockwise(child_fn(dt), block_dim)
        return f

    return {
        "dj_identity": _wrap(lambda dt: P.identity()),
        "dj_lower": _wrap(lambda dt: P.lower_bound(-torch.ones(block_dim), dt, device)),
        "dj_box": _wrap(lambda dt: P.box(-torch.ones(block_dim), torch.ones(block_dim),
                                         dt, device)),
        "dj_ball": _wrap(lambda dt: P.ball(1.0, dtype=dt, device=device)),
        "dj_cone": _wrap(lambda dt: P.lorentz_cone(1.0, dtype=dt, device=device)),
    }
