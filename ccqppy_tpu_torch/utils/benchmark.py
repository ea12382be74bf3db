"""Roofline-guarded timing of batched solves, and device-only kernel times.

Port of ``materialize``, ``TimedRun``, ``timed_run`` and
``dense_sweep_bytes`` from ``ccqppy_tpu/utils/benchmark.py``.  PyTorch
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
import statistics
import time

import torch

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
