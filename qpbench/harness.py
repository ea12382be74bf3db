"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (``setup_s``, from the start of the process): torch with TF32 off,
the CUDA context, the cell's files by name, the entry (which imports the
program), the ensemble made on the device from the seed, the entry's own
``prepare`` (the kernel library, the mix's prep) and one warm-up call at
the cell's shapes; then the device's peak-memory count is reset.  Each
part's seconds go to standard error on a ``setup:`` line.

The window: one caller in a closed loop for ``seconds``.  Call k draws its
right-hand sides on the device from ``(seed, k)`` (``traffic.call_rhs``),
calls the entry, and ends when the answers (x, the converged flags, the
matvec counts) are in pinned host buffers.  Every call's wall is kept.
Where the entry exposes the program's ``counters()``, they are read once
before a stretch of calls starts its clock and once after its seconds are
taken, and the stretch keeps their gains.  A traced run (``--trace 1``)
adds, after that unprofiled window, the mix's ``profiled_calls`` calls
under ``torch.profiler``.

After the window: the peak memory is read, the program's state is freed,
the import check runs again, and the sampled answers go through the check
(``check.judge``).  The cell's metrics are read from the run's ``Record``
by one reader each (``metrics/<name>.py``).
"""
from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from qpbench import check, guard, trace, traffic
from qpbench.registry import Registry


class ForbiddenImport(RuntimeError):
    """A module of the JAX package or of JAX itself was loaded."""


@dataclass
class Part:
    """The calls of one stretch of the window."""
    window_s: float = 0.0
    walls: list = field(default_factory=list)      # seconds a call
    matvecs: list = field(default_factory=list)    # (lanes,) int32 a call
    converged: int = 0
    lanes: int = 0
    counters: dict | None = None   # the program's counters' gains; None without


@dataclass
class Record:
    """What a metric reader reads (``read(record)``)."""
    config: dict
    mix: dict
    setup_s: float
    window: Part                   # the unprofiled window
    uncounted_sweeps: int          # a lane's sweeps a call outside its matvecs
    device_kind: str
    peak_bytes: int | None         # device memory peak of the window
    profiled: Part | None = None   # the profiled calls (traced runs)
    trace: trace.TraceSummary | None = None
    events: list | None = None     # the profiled calls' profiler events (traced runs)


class Caller:
    """The closed loop: draw b, call the entry, fetch the answers."""

    def __init__(self, entry, state, b0, seed, noise, sampler, counters=None):
        self.entry, self.state, self.b0 = entry, state, b0
        self.seed, self.noise, self.sampler = seed, noise, sampler
        self.counters = counters
        self.k = 0
        B, n = b0.shape
        pin = b0.device.type == "cuda"
        self.x = torch.empty((B, n), dtype=b0.dtype, pin_memory=pin)
        self.conv = torch.empty(B, dtype=torch.bool, pin_memory=pin)
        self.mv = torch.empty(B, dtype=torch.int32, pin_memory=pin)

    def fetch(self, r):
        self.x.copy_(r.x, non_blocking=True)
        self.conv.copy_(r.converged, non_blocking=True)
        self.mv.copy_(r.matvecs, non_blocking=True)
        if self.b0.device.type == "cuda":
            torch.cuda.current_stream(self.b0.device).synchronize()
        return self.x.numpy(), self.conv.numpy(), self.mv.numpy()

    def warm_up(self):
        self.fetch(self.entry.call(self.state, traffic.call_rhs(self.b0, self.seed, -1,
                                                                self.noise)))

    def run(self, seconds=None, calls=None):
        """Calls until ``seconds`` have passed or ``calls`` were made."""
        part, k0 = Part(), self.k
        before = self.counters() if self.counters else None
        t_start = time.perf_counter()
        while True:
            if seconds is not None and time.perf_counter() - t_start >= seconds:
                break
            if calls is not None and self.k - k0 >= calls:
                break
            with torch.profiler.record_function(trace.DRAW_SPAN):
                b = traffic.call_rhs(self.b0, self.seed, self.k, self.noise)
            t = time.perf_counter()
            with torch.profiler.record_function(trace.CALL_SPAN):
                r = self.entry.call(self.state, b)
            with torch.profiler.record_function(trace.FETCH_SPAN):
                x, conv, mv = self.fetch(r)
            part.walls.append(time.perf_counter() - t)
            del r, b
            mv = mv.copy()
            part.matvecs.append(mv)
            part.converged += int(conv.sum())
            part.lanes += conv.shape[0]
            self.sampler.offer(self.k, x, conv, mv)
            self.k += 1
        part.window_s = time.perf_counter() - t_start
        if before is not None:
            part.counters = {k: v - before[k] for k, v in self.counters().items()}
        return part


def _shrunk(config, mix, shrink):
    """Test-only: the configuration and mix at other sizes."""
    config, mix = dict(config), dict(mix)
    for k, v in (shrink or {}).items():
        (mix if k in mix else config)[k] = v
    return config, mix


def _profile(caller, calls, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        part = caller.run(calls=calls)
    events = prof.events()
    dev, host = trace.profiler_events(events)
    return part, trace.summarize(dev, host, calls), list(events)


class SetupClock:
    """The parts of set-up: each part's seconds since the one before."""

    def __init__(self, t0, device):
        self.last, self.device, self.parts = t0, device, []

    def lap(self, name, now=None):
        if now is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def line(self):
        total = sum(s for _, s in self.parts)
        return "setup: " + ", ".join(f"{n} {s:.3f}" for n, s in self.parts) + \
            f"; {total:.3f} s"


def run_cell(workload, seed, seconds, traced, device="cuda", registry=None, t0=None,
             shrink=None, entry=None, imported=None, keep=None):
    """Run the cell once; returns (result line as a dict, the check's lines).

    ``t0`` is the start of set-up (the process's start) and ``imported`` the
    time torch had been imported by, when the caller took it.  ``shrink``
    (sizes) and ``entry`` (a module in the mix's entry's place: the
    control, or a broken program) are for tests and readings only, as is
    ``keep``: a list that receives the run's ``Record``."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    clock = SetupClock(t0, device)
    if imported is not None:
        clock.lap("imports", imported)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    clock.lap("context")
    reg = registry or Registry()
    cell = reg.workload(workload)
    config, mix = _shrunk(reg.config(cell["config"]), reg.mix(cell["traffic"]), shrink)
    entry = entry or reg.entry(mix["entry"])
    wanted = reg.metrics(workload, traced)
    readers = {m["name"]: reg.reader(m["name"]) for m in wanted}
    bad = guard.forbidden_loaded()
    if bad:
        raise ForbiddenImport(f"loaded before the window: {', '.join(bad)}")
    clock.lap("entry")

    A, b0, _ = traffic.ensemble(config, int(mix["lanes"]), seed, device)
    clock.lap("ensemble")
    state = entry.prepare(SimpleNamespace(A=A, b0=b0, config=config, device=device), mix)
    clock.lap("prepare")
    sampler = traffic.Sampler(mix["sample"], seed)
    caller = Caller(entry, state, b0, seed, float(mix["noise"]), sampler,
                    counters=getattr(entry, "counters", None))
    caller.warm_up()
    clock.lap("warm_up")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    window = caller.run(seconds=seconds)
    profiled = summary = events = None
    if traced:
        profiled, summary, events = _profile(caller, int(mix["profiled_calls"]), device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    del caller, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = guard.forbidden_loaded()
    if bad:
        raise ForbiddenImport(f"loaded by the end of the window: {', '.join(bad)}")

    checks, refused, info = check.judge(config, reg.checks(workload), A, b0, seed,
                                        float(mix["noise"]), sampler.records())
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec = Record(config=config, mix=mix, setup_s=setup_s,
                 window=window, uncounted_sweeps=int(getattr(entry, "UNCOUNTED_SWEEPS", 0)),
                 device_kind=kind, peak_bytes=peak, profiled=profiled, trace=summary,
                 events=events)
    if keep is not None:
        keep.append(rec)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    parts = [window] + ([profiled] if profiled else [])
    attempted = sum(p.lanes for p in parts)
    unconverged = attempted - sum(p.converged for p in parts)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    if traced and summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
    result = {"correct": check.passed(checks), "attempted": attempted,
              "failed": unconverged + refused, "metrics": metrics, "device": dev}
    if traced and summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    walls = np.array(window.walls) * 1e3
    fifth = max(1, len(walls) // 5)
    lines = [clock.line()]
    lines += [f"window: {len(walls)} calls in {window.window_s:.3f} s, wall ms p10 "
             f"{np.percentile(walls, 10):.3f} p50 {np.median(walls):.3f} p90 "
             f"{np.percentile(walls, 90):.3f}; p50 of the first fifth {np.median(walls[:fifth]):.3f}, "
             f"of the last {np.median(walls[-fifth:]):.3f}" if len(walls) else "window: no call"]
    lines += [f"check: {len(sampler.records())} sampled lanes of {info.get('calls', 0)} calls, "
             f"{unconverged} of {attempted} lanes unconverged, {refused} refused; reference "
             f"residual max {info.get('reference_residual_max', float('nan')):.3e} in "
             f"{info.get('reference_steps_max', 0)} steps"]
    lines += [f"{name} {c['value']:.6e} limit {c['limit']}" for name, c in checks.items()]
    return result, lines


def emit(result, lines):
    """The result line last on standard output; the compared numbers last on
    standard error."""
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
