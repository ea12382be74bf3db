"""The program's own spans and counters, read over a cell's traced run.

    python3 qpbench/program_trace.py --workload <cell> --seeds 1 2 --seconds 50 \
        [--span-cost] [--out readings.json]

The port records spans while a profiler records (``ccqppy.solve`` around
each batch entry, ``ccqppy.phase1``, ``ccqppy.gather``, ``ccqppy.phase2``,
``ccqppy.fallback`` inside compaction) and keeps counters (GEMV launches,
the lanes of A they streamed, host reads of a device value;
``entries/_program.py``).  The harness keeps neither counters nor span
intervals, so no metric of ``BENCHMARK.json`` reads them.  This script runs
each seed as ``run.py --trace 1`` does (``harness.run_cell``, traced: the
unprofiled window, then the mix's profiled calls), with ``Caller.run`` and
``trace.profiler_events`` wrapped for the run to keep what they see, and
prints beside each result line four readings:

* ``gemv_useful_sweeps_pct``: the sweeps the window's lanes needed (each
  lane's reported matvecs plus the entry's ``UNCOUNTED_SWEEPS``) over the
  lanes of A the GEMV kernel streamed in the window, in %;
* ``host_syncs_per_call``: the window's host reads per call;
* ``phase2_wall_pct``: the union of the ``ccqppy.gather`` and
  ``ccqppy.phase2`` spans of the profiled calls over the sum of their
  walls, in % (mixes with compaction);
* ``device_idle_in_solve_pct``: the device's idle time inside the
  ``ccqppy.solve`` spans (their exact overlap) over the traced window, in %;
  the rest of the idle share is the caller's (draw, start point, fetch);

and four checks of the trace: every device operation lies inside some
call's [draw start, fetch end], and no kernel starts before its own
``cudaLaunchKernel`` (host and device on one clock); each GEMV kernel
whose launch lies in a ``ccqppy.phase2`` span starts after that span
starts; the GEMV kernels in the trace number the program's GEMV launches
in the profiled calls.  A reading is None where the program keeps
no such counter or span, or where the entry in the mix's place (the
control) is not the program.  ``--span-cost`` times, with no profiler
running, a ``record_function`` (the benchmark's own spans) and the
program's gated ``span``.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from qpbench import harness, trace  # noqa: E402
from qpbench.entries import _program  # noqa: E402
from qpbench.registry import Registry  # noqa: E402

SOLVE_SPAN = "ccqppy.solve"
PHASE2_SPANS = ("ccqppy.gather", "ccqppy.phase2")
LAUNCH = "cudaLaunchKernel"


@dataclass
class Recording:
    """What one traced run showed of the program."""
    parts: list = field(default_factory=list)   # (Part, counter gains or None) a stretch
    events: list = field(default_factory=list)  # the profiled calls' FunctionEvents
    dev: list = field(default_factory=list)     # (name, start_s, end_s), device
    host: list = field(default_factory=list)    # (name, start_s, end_s), host


@contextlib.contextmanager
def recording(read=_program.counters):
    """Wrap ``Caller.run`` (the counters' gains over each stretch, with
    ``read``; none when ``read`` is None) and ``trace.profiler_events`` (the
    profiled calls' events) while the block runs."""
    rec = Recording()
    run0, events0 = harness.Caller.run, trace.profiler_events

    def run(caller, seconds=None, calls=None):
        before = read() if read else None
        part = run0(caller, seconds=seconds, calls=calls)
        gains = None if read is None else {k: v - before[k] for k, v in read().items()}
        rec.parts.append((part, gains))
        return part

    def events(prof):
        rec.events = list(prof.events())
        rec.dev, rec.host = events0(prof)
        return rec.dev, rec.host

    harness.Caller.run, trace.profiler_events = run, events
    try:
        yield rec
    finally:
        harness.Caller.run, trace.profiler_events = run0, events0


def _window(host):
    """The traced window as ``trace.summarize`` takes it: the first call
    span's start to the last fetch span's end; None without a call span."""
    starts = [s for n, s, _ in host if n == trace.CALL_SPAN]
    ends = [e for n, _, e in host if n == trace.FETCH_SPAN] or \
        [e for n, _, e in host if n == trace.CALL_SPAN]
    return (min(starts), max(ends)) if starts else None


def _clipped(intervals, w0, w1):
    return trace.merged((max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1)


def _overlap(a, b):
    """Total length shared by two sorted, disjoint lists of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_readings(dev, host):
    """From plain (name, start_s, end_s) lists: the traced window's seconds,
    the union of the phase-2 spans in it, and the device's idle time inside
    the union of its solve spans.  The last two are None without a solve
    span in the window; all three None without a call span or a device
    operation."""
    w = _window(host)
    if w is None or not dev:
        return {"window_s": None, "phase2_s": None, "idle_in_solve_s": None}
    w0, w1 = w
    busy = _clipped(((s, e) for _, s, e in dev), w0, w1)
    idle, prev = [], w0
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        idle.append((prev, w1))
    solves = _clipped(((s, e) for n, s, e in host if n == SOLVE_SPAN), w0, w1)
    if not solves:
        return {"window_s": w1 - w0, "phase2_s": None, "idle_in_solve_s": None}
    phase2 = _clipped(((s, e) for n, s, e in host if n in PHASE2_SPANS), w0, w1)
    return {"window_s": w1 - w0, "phase2_s": sum(e - s for s, e in phase2),
            "idle_in_solve_s": _overlap(idle, solves)}


def readings(rec, mix, uncounted_sweeps):
    """The four readings of one traced run (see the module's docstring)."""
    window, wgain = rec.parts[0]
    profiled = rec.parts[1][0] if len(rec.parts) > 1 else None
    spans = span_readings(rec.dev, rec.host)
    out = dict.fromkeys(("gemv_useful_sweeps_pct", "host_syncs_per_call", "phase2_wall_pct",
                         "device_idle_in_solve_pct"))
    swept = (wgain or {}).get("gemv_lanes_swept")
    if swept and window.matvecs:
        needed = sum(int(m.sum()) + uncounted_sweeps * m.shape[0] for m in window.matvecs)
        out["gemv_useful_sweeps_pct"] = 100.0 * needed / swept
    syncs = (wgain or {}).get("host_syncs")
    if syncs is not None and window.walls:
        out["host_syncs_per_call"] = syncs / len(window.walls)
    if "phase1" in mix and spans["phase2_s"] is not None and profiled and profiled.walls:
        out["phase2_wall_pct"] = 100.0 * spans["phase2_s"] / sum(profiled.walls)
    if spans["idle_in_solve_s"] is not None:
        out["device_idle_in_solve_pct"] = 100.0 * spans["idle_in_solve_s"] / spans["window_s"]
    return out


def ops_outside_calls(dev, host):
    """Device operations not inside any call's [draw start, fetch end]."""
    draws = sorted(s for n, s, _ in host if n == trace.DRAW_SPAN)
    fetches = sorted((s, e) for n, s, e in host if n == trace.FETCH_SPAN)
    calls = [(d, f[1]) for d, f in zip(draws, fetches)]
    starts = [c[0] for c in calls]
    out = 0
    for _, s, e in dev:
        k = bisect.bisect_right(starts, s) - 1
        out += not (k >= 0 and e <= calls[k][1])
    return out


def _linked_kernels(events):
    """(device kernel, the host start of its ``cudaLaunchKernel``) for each
    kernel the profiler links to a launch by correlation id."""
    from torch.autograd import DeviceType

    launches = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH)}
    return [(k, launches[k.id]) for k in events
            if k.device_type == DeviceType.CUDA and k.id in launches]


def phase2_launch_order(events):
    """(GEMV kernels whose launch lies in a ``ccqppy.phase2`` span, those of
    them that start before the span does)."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU and e.name == "ccqppy.phase2"]
    linked = early = 0
    for k, t in _linked_kernels(events):
        if trace.GEMV_NAME not in k.name:
            continue
        for s, e in spans:
            if s <= t <= e:
                linked += 1
                early += k.time_range.start < s
    return linked, early


def kernels_before_launch(events):
    """(kernels stamped before their own launch, the largest such lead in
    µs): a lead means the device's timestamps run behind the host's."""
    leads = [t - k.time_range.start for k, t in _linked_kernels(events)
             if k.time_range.start < t]
    return len(leads), max(leads, default=0.0)


def traced_run(cell, seed, seconds, device="cuda", registry=None, shrink=None, entry=None):
    """One traced run of the cell (``harness.run_cell``) and what it showed
    of the program: (result line, the check's lines, the readings and
    checks).  With ``entry`` (the control, a test's stand-in) in the mix's
    entry's place, the program's counters are not read."""
    reg = registry or Registry()
    w = reg.workload(cell)
    _, mix = harness._shrunk(reg.config(w["config"]), reg.mix(w["traffic"]), shrink)
    uncounted = int(getattr(entry or reg.entry(mix["entry"]), "UNCOUNTED_SWEEPS", 0))
    with recording(read=None if entry is not None else _program.counters) as rec:
        result, lines = harness.run_cell(cell, seed, seconds, True, device=device,
                                         registry=reg, shrink=shrink, entry=entry)
    program = readings(rec, mix, uncounted)
    if len(rec.parts) > 1:
        profiled, pgain = rec.parts[1]
        program["profiled_wall_ms"] = [1e3 * t for t in profiled.walls]
        program["gemv_launches"] = (pgain or {}).get("gemv_launches")
    if rec.dev:
        program["gemv_kernels"] = sum(trace.GEMV_NAME in n for n, _, _ in rec.dev)
        program["ops_outside_calls"] = ops_outside_calls(rec.dev, rec.host)
        program["phase2_gemv_linked"], program["phase2_gemv_early"] = \
            phase2_launch_order(rec.events)
        program["kernels_before_launch"], program["kernel_lead_us"] = \
            kernels_before_launch(rec.events)
    return result, lines, program


def span_cost_us(n=20000, rounds=5):
    """Median µs to enter and leave, with no profiler running, a
    ``record_function`` and the program's gated ``span`` (where it has one)."""
    out = {}
    for name, make in (("record_function", torch.profiler.record_function),
                       ("program_span", _program.span)):
        if make is None:
            continue
        times = []
        for _ in range(rounds):
            t = time.perf_counter()
            for _ in range(n):
                with make("qpbench.cost"):
                    pass
            times.append((time.perf_counter() - t) / n * 1e6)
        out[name] = statistics.median(times)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the program's trace is read on the card")
    runs = []
    for seed in a.seeds:
        result, lines, program = traced_run(a.workload, seed, a.seconds)
        run = {"workload": a.workload, "seed": seed, "correct": result["correct"],
               "metrics": {k: v["value"] for k, v in result["metrics"].items()},
               "device": result["device"], "breakdown": result.get("breakdown"),
               "program": program, "lines": lines}
        runs.append(run)
        print(json.dumps(run), flush=True)
    if a.span_cost:
        cost = span_cost_us()
        runs.append({"span_cost_us": cost})
        print(json.dumps({"span_cost_us": cost}), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
