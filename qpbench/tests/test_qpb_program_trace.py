"""The port's readings as their readers take them from a run's record
(``metrics/``: the span reduction on made-up lists, the None cases, the
counters of a program that lacks some) and the checks of
``qpbench/program_trace.py`` (on the card one clock for host and device,
and the GEMV launches counted)."""
import math

import numpy as np
import pytest
import torch

from qpbench import harness, program_trace, trace
from qpbench.entries import _program
from qpbench.reference import control
from qpbench.registry import Registry

SEED = 2**31 + 91


class TinyLimits(Registry):
    def checks(self, cell):
        return {"x_gap_max": {"limit": 1e-4}}


def _window():
    """Two calls; device busy 0.1-0.3, 0.5-0.6, 1.6-1.9 of a window 0-2.1."""
    host = [("qpbench.draw", -0.1, 0.0), ("qpbench.call", 0.0, 1.0),
            ("qpbench.fetch", 1.0, 1.2), ("qpbench.draw", 1.4, 1.5),
            ("qpbench.call", 1.5, 2.0), ("qpbench.fetch", 2.0, 2.1)]
    dev = [("void batched_gemv_kernel<float>", 0.1, 0.3), ("add", 0.5, 0.6),
           ("void batched_gemv_kernel<float>", 1.6, 1.9)]
    return dev, host


def _record(dev, host, gains=None, mix=None, walls=(1.0, 0.6)):
    """A run's record: a window of two calls of 4 lanes (10 and 20 matvecs
    a lane) with the counters' ``gains``, and the profiled calls' ``walls``
    traced as ``dev`` and ``host``."""
    window = harness.Part(window_s=1.0, walls=[0.5, 0.5],
                          matvecs=[np.full(4, 10, np.int32), np.full(4, 20, np.int32)],
                          counters=gains)
    return harness.Record(config={"n": 24, "dtype": "float32"},
                          mix={"phase1": 3} if mix is None else mix, setup_s=1.0, window=window,
                          uncounted_sweeps=0, device_kind="cpu", peak_bytes=None,
                          profiled=harness.Part(walls=list(walls)),
                          trace=trace.summarize(dev, host, 2))


def _read(rec):
    reg = Registry()
    return {name: reg.reader(name).read(rec) for name in program_trace.READINGS}


def test_span_readings_on_made_up_lists():
    dev, host = _window()
    r = _read(_record(dev, host))
    assert math.isclose(_record(dev, host).trace.window_s, 2.1)
    assert r["phase2_wall_pct"] is None and r["device_idle_in_solve_pct"] is None
    # Solve spans: 0.05-0.7 with a nested entry's span 0.2-0.4 inside it,
    # and 1.45-1.95, which begins before the second call; phase 2: a gather
    # 0.4-0.45 overlapping a phase-2 span 0.42-0.55, nested in a fallback.
    host += [("ccqppy.solve", 0.05, 0.7), ("ccqppy.solve", 0.2, 0.4),
             ("ccqppy.gather", 0.4, 0.45), ("ccqppy.fallback", 0.41, 0.6),
             ("ccqppy.phase2", 0.42, 0.55), ("ccqppy.solve", 1.45, 1.95)]
    r = _read(_record(dev, host))
    assert math.isclose(r["phase2_wall_pct"], 100 * 0.15 / 1.6)
    # Idle in [0, 2.1]: 0-0.1, 0.3-0.5, 0.6-1.6, 1.9-2.1; inside the solve
    # spans: 0.05-0.1, 0.3-0.5, 0.6-0.7, 1.45-1.6, 1.9-1.95.
    assert math.isclose(r["device_idle_in_solve_pct"],
                        100 * (0.05 + 0.2 + 0.1 + 0.15 + 0.05) / 2.1)
    # A span that outlasts the window is clipped to it.
    host += [("ccqppy.phase2", 2.0, 3.0)]
    assert math.isclose(_read(_record(dev, host))["phase2_wall_pct"], 100 * 0.25 / 1.6)
    assert _read(_record([], host))["phase2_wall_pct"] is None
    assert program_trace.ops_outside_calls(dev, host) == 0
    assert program_trace.ops_outside_calls(dev + [("late", 1.25, 1.3)], host) == 1


PROGRAM = {"gemv_launches": 9, "gemv_lanes_swept": 150, "host_syncs": 30}
SPANS = [("ccqppy.solve", 0.0, 1.0), ("ccqppy.phase2", 0.5, 0.7)]


@pytest.mark.parametrize("gains,spans,mix,want", [
    (PROGRAM, SPANS, {"phase1": 3}, (80.0, 15.0, 12.5, 100 * 0.7 / 2.1)),
    (PROGRAM, SPANS, {}, (80.0, 15.0, None, 100 * 0.7 / 2.1)),
    # The control in the program's place: no counters read, no spans.
    (None, [], {"phase1": 3}, (None, None, None, None)),
    # An older program: only the launch counter, no spans.
    ({"gemv_launches": 9}, [], {"phase1": 3}, (None, None, None, None)),
], ids=["compaction", "no-phase1", "control", "older-program"])
def test_readings(gains, spans, mix, want):
    dev, host = _window()
    r = _read(_record(dev, host + spans, gains=gains, mix=mix))
    got = (r["gemv_useful_sweeps_pct"], r["host_syncs_per_call"], r["phase2_wall_pct"],
           r["device_idle_in_solve_pct"])
    for g, w in zip(got, want):
        assert (g is None and w is None) or math.isclose(g, w)


def test_counters_leave_out_what_the_program_lacks(monkeypatch):
    from ccqppy_tpu_torch.models import base
    from ccqppy_tpu_torch.ops import gemv

    assert set(_program.counters()) == {"gemv_launches", "gemv_lanes_swept", "host_syncs",
                                        "sc_steps_fused", "sc_steps_eager"}
    monkeypatch.delattr(gemv, "LANES_SWEPT")
    monkeypatch.delattr(base, "HOST_SYNCS")
    assert set(_program.counters()) == {"gemv_launches", "sc_steps_fused", "sc_steps_eager"}


@pytest.mark.parametrize("entry", [None, control], ids=["program", "control"])
def test_a_traced_run_on_the_cpu(entry, tiny):
    result, _, program = program_trace.traced_run(
        "box1000.iterative", SEED, 0.3, device="cpu", registry=TinyLimits(), shrink=tiny,
        entry=entry)
    assert result["correct"] is (entry is None)
    # No device trace and no kernel launch on the CPU; the syncs are counted.
    assert program["gemv_useful_sweeps_pct"] is None and program["phase2_wall_pct"] is None
    assert program["device_idle_in_solve_pct"] is None
    if entry is None:
        assert program["host_syncs_per_call"] > 1 and program["gemv_launches"] == 0
        assert result["metrics"]["host_syncs_per_call"]["value"] == program["host_syncs_per_call"]
    else:
        assert program["host_syncs_per_call"] is None and program["gemv_launches"] is None


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_one_clock_and_phase2_launches_on_the_card():
    """Every device operation of the profiled iterative calls lies inside a
    call's [draw start, fetch end] (the fetch ends in a synchronise, so a
    skew between the clocks would put operations outside) and starts after
    its own launch, and each GEMV kernel launched in a phase-2 span starts
    after that span starts."""
    need_card()
    result, _, p = program_trace.traced_run("box1000.iterative", SEED, 1.0,
                                            shrink={"lanes": 256})
    assert result["correct"]
    assert p["ops_outside_calls"] == 0 and p["kernels_before_launch"] == 0
    assert p["phase2_gemv_linked"] > 0 and p["phase2_gemv_early"] == 0
    assert 0 < p["phase2_wall_pct"] < 100 and 0 <= p["device_idle_in_solve_pct"] < 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["box1000.iterative", "box1000.direct", "cone999.apgd_sc"])
def test_gemv_launches_match_the_trace_on_the_card(cell):
    """The GEMV kernels in the profiled calls' trace number the program's
    launches; the lanes it streamed cover the sweeps counted."""
    need_card()
    result, _, p = program_trace.traced_run(cell, SEED, 1.0, shrink={"lanes": 64})
    assert result["correct"]
    assert p["gemv_kernels"] == p["gemv_launches"] > 0
    assert 0 < p["gemv_useful_sweeps_pct"] <= 100 and p["host_syncs_per_call"] >= 1
