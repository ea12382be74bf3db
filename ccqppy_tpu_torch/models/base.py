"""Shared solver machinery: results, configs, convergence criterion.

Port of ``ccqppy_tpu/models/base.py`` with an explicit batch dimension:
every ``SolveResult`` field carries a leading lane axis, and
``pg_residual`` is a per-lane norm.

* ``pg_residual`` -- the Mazhar-2015 Eq. 25 normalized projected-gradient
  residual ``|| (x - proj(x - gd*g)) || / (3 n gd)``, evaluated through each
  projection's cancellation-free closed form so it stays meaningful in f32.
* Budget semantics: ``converged := matvecs < max_matvecs`` at exit.
* Telemetry: ``span`` marks a stretch of host time for ``torch.profiler``
  and costs one check of the profiler's state when none records;
  ``any_lane``, ``lane_indices`` and ``host_flag`` are the solvers' only
  reads of a device value on the host, each counted in ``HOST_SYNCS``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

#: Host reads of a device value in this process (``any_lane``,
#: ``lane_indices`` and ``host_flag``): on CUDA each waits for the stream
#: to drain.
HOST_SYNCS = 0

_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class SolveResult:
    """Result of a batch of QP solves; every field has a leading lane axis."""

    x: torch.Tensor          # (B, n) solution iterate
    residual: torch.Tensor   # (B,) final Eq. 25 residual
    converged: torch.Tensor  # (B,) bool
    matvecs: torch.Tensor    # (B,) int32 count of operator applications
    iterations: torch.Tensor # (B,) int32 iteration count
    solve_time: torch.Tensor # (B,) seconds; filled by timed wrappers, else 0
    trace: torch.Tensor      # (B, trace_len) residual history; (B, 0) when off


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters common to all solvers.

    tol:          desired Eq. 25 residual.
    max_matvecs:  operator-application budget per lane.
    gd:           finite-difference probe step of the residual criterion.
    trace_len:    length of the per-lane residual history (0 = off).
    """

    tol: float = 1e-8
    max_matvecs: int = 10_000
    gd: float = 1e-6
    trace_len: int = 0


def pg_residual(proj, x, g, gd, op=None):
    """Per-lane normalized projected-gradient residual (Eq. 25): (B,)."""
    r = proj.pg_residual_vec(x, g, gd)
    if op is None:
        return torch.linalg.vector_norm(r, dim=-1) / (3.0 * x.shape[-1])
    return torch.sqrt(op.dot(r, r)) / (3.0 * op.global_size(x))


def make_result(x, residual, matvecs, iterations, max_matvecs, trace=None):
    B = x.shape[0]
    return SolveResult(
        x=x,
        residual=residual,
        converged=matvecs < max_matvecs,
        matvecs=matvecs.to(torch.int32),
        iterations=iterations.to(torch.int32),
        solve_time=torch.zeros(B, dtype=x.dtype, device=x.device),
        trace=trace if trace is not None
        else torch.zeros((B, 0), dtype=x.dtype, device=x.device),
    )


def init_trace(config, batch, dtype, device):
    """Residual-history buffer: (B, trace_len) filled with NaN."""
    return torch.full((batch, config.trace_len), torch.nan, dtype=dtype,
                      device=device)


def record_trace(trace, it, res):
    """Record each lane's residual at its iteration ``it`` (B,).  Iterations
    beyond the buffer are dropped; a disabled buffer is returned as is."""
    if trace.shape[-1] == 0:
        return trace
    hit = torch.arange(trace.shape[-1], device=trace.device) == it[:, None]
    return torch.where(hit, res[:, None].to(trace.dtype), trace)


def default_x0(b, x0, proj=None):
    """x0 = 0 by default; a given x0 is cast to b's dtype.  With ``proj``
    the start point is projected onto the feasible set."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    else:
        x0 = torch.as_tensor(x0).to(dtype=b.dtype)
    if proj is not None:
        x0 = proj.project(x0)
    return x0


def lanes(v):
    """A per-lane (B,) tensor as a (B, 1) column, to scale (B, n) rows."""
    return v[:, None]


def where_lanes(mask, new, old):
    """Per lane: ``new`` where ``mask`` (B,), else ``old``; either may carry
    trailing axes after the lane axis."""
    ndim = max(new.dim(), old.dim())
    return torch.where(mask.view(-1, *([1] * (ndim - 1))), new, old)


def select_lanes(mask, new, old):
    """Per lane, every field of the state ``new`` where ``mask`` (B,), else
    of ``old`` (NamedTuples of tensors with a leading lane axis)."""
    return type(old)(*(where_lanes(mask, n_, o) for n_, o in zip(new, old)))


def eps_of(x):
    """10*eps stagnation guard."""
    return 10 * torch.finfo(x.dtype).eps


def span(name):
    """A ``torch.profiler.record_function(name)`` while a profiler records,
    else a shared no-op context: nothing is entered when no one profiles."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def any_lane(mask):
    """``bool(mask.any())``, read on the host; counted in ``HOST_SYNCS``."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(mask.any())


def host_flag(values, i, device):
    """``values[i]`` of an int64 array over host memory that ``device``
    writes (a loop's flag, ``ops.loop_flag``) after the host has set it to
    -1, read on the host once written; counted in ``HOST_SYNCS``.  The host
    waits by reading the memory, with no call into CUDA: at B = 1 a stream's
    synchronisation and a copy cost a tenth of a pass.  Where the device's
    current stream has finished and the flag is still -1, the device never
    wrote it: ``RuntimeError``."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    spins = 0
    while values[i] < 0:
        spins += 1
        if spins % 1024 == 0 and torch.cuda.current_stream(device).query() and values[i] < 0:
            raise RuntimeError("the device finished without writing the loop's flag")
    return int(values[i])


def lane_indices(mask):
    """The indices of the set lanes of ``mask`` (B,), as a (k,) tensor; the
    count k is read on the host, counted in ``HOST_SYNCS``."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return torch.nonzero(mask).squeeze(1)
