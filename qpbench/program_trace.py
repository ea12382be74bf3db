"""Checks of a cell's traced run that its metrics do not make.

    python3 qpbench/program_trace.py --workload <cell> --seeds 1 2 --seconds 50 \
        [--span-cost] [--out readings.json]

Each seed runs as ``run.py --trace 1`` does (``harness.run_cell``, traced:
the unprofiled window, then the mix's profiled calls), keeping the run's
``Record``.  Beside each result line it prints the port's four readings,
as their readers (``metrics/<name>.py``) take them from that record
(``READINGS``; None where the program keeps no such counter or span, or
where the entry in the mix's place is not the program), and four checks
of the trace: every device operation lies inside some call's [draw start,
fetch end], and no kernel starts before its own ``cudaLaunchKernel``
(host and device on one clock); each GEMV kernel whose launch lies in a
``ccqppy.phase2`` span starts after that span starts; the GEMV kernels in
the trace number the program's GEMV launches in the profiled calls.
``--span-cost`` times, with no profiler running, a ``record_function``
(the benchmark's own spans) and the program's gated ``span``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from qpbench import harness, trace  # noqa: E402
from qpbench.entries import _program  # noqa: E402
from qpbench.registry import Registry  # noqa: E402

READINGS = ("gemv_useful_sweeps_pct", "host_syncs_per_call", "phase2_wall_pct",
            "device_idle_in_solve_pct")
LAUNCH = "cudaLaunchKernel"


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
    keep = []
    result, lines = harness.run_cell(cell, seed, seconds, True, device=device, registry=reg,
                                     shrink=shrink, entry=entry, keep=keep)
    rec = keep[0]
    program = {name: reg.reader(name).read(rec) for name in READINGS}
    if rec.profiled is not None:
        program["profiled_wall_ms"] = [1e3 * t for t in rec.profiled.walls]
        program["gemv_launches"] = (rec.profiled.counters or {}).get("gemv_launches")
    if rec.events:
        dev, host = trace.profiler_events(rec.events)
        if dev:
            program["gemv_kernels"] = sum(trace.GEMV_NAME in n for n, _, _ in dev)
            program["ops_outside_calls"] = ops_outside_calls(dev, host)
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
