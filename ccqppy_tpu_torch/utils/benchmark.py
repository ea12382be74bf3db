"""Roofline-guarded timing of batched solves.

Port of ``materialize``, ``TimedRun``, ``timed_run`` and
``dense_sweep_bytes`` from ``ccqppy_tpu/utils/benchmark.py``.  PyTorch
launches CUDA work asynchronously, so the fence that closes a timed rep is
``torch.cuda.synchronize`` of every device the outputs live on; outputs
are then copied to the host and checked outside the clock.
"""
from __future__ import annotations

import dataclasses
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
