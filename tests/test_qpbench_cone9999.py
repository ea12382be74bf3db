"""The benchmark's cone9999.mprgp_bb cell on the CPU: its readers on a
record made by hand, and a tiny traced run through the unchanged harness,
whose program counters the new readers read."""
import math

import numpy as np
import pytest
import torch

from qpbench import guard, harness, trace
from qpbench.registry import Registry

CELL = "cone9999.mprgp_bb"
HBM = 3.35e12
torch.set_num_threads(1)


def _record(counters, kernels, walls=(0.5, 0.7), calls=2, n=9999):
    """A traced record of a B = 1 mix: a window with ``walls`` and the
    counter gains ``counters``, two profiled calls with the same gains and
    the kernels ``kernels`` (name -> (seconds, launches))."""
    window = harness.Part(window_s=sum(walls) + 0.1, walls=list(walls),
                          matvecs=[np.array([60]) for _ in walls], converged=len(walls),
                          lanes=len(walls), counters=dict(counters))
    profiled = harness.Part(window_s=1.0, walls=[0.5] * calls,
                            matvecs=[np.array([60]) for _ in range(calls)], converged=calls,
                            lanes=calls, counters=dict(counters))
    summary = trace.TraceSummary(
        window_s=1.0, busy_s=0.1, kernels=sum(k for _, k in kernels.values()), gemv_s=0.0,
        other_kernel_s=0.0, device_ops=[], idle_gaps=[],
        kernel_s={k: s for k, (s, _) in kernels.items()},
        kernel_launches={k: c for k, (_, c) in kernels.items()}, spans={}, idle=[])
    reg = Registry()
    return harness.Record(config=reg.config("cone9999") | {"n": n}, mix=reg.mix("mprgp_bb"),
                          setup_s=1.0, window=window, uncounted_sweeps=0,
                          device_kind="NVIDIA H100 80GB HBM3", peak_bytes=1, profiled=profiled,
                          trace=summary)


GEMV64 = ("void (anonymous namespace)::batched_gemv_kernel<float, double>(float const*, "
          "double const*, double*, long, long, long, int)")


def test_the_readers_by_hand():
    reg = Registry()
    kernels = {GEMV64: (0.02, 120), "void at::native::elementwise_kernel<add>": (0.01, 1880)}
    rec = _record({"mprgp_iters": 100, "gemv_launches_f32_f64": 120}, kernels)
    # 1.2 s of calls over 100 loop passes; 2,000 kernels over 100 passes.
    assert math.isclose(reg.reader("iter_ms.host_bound").read(rec), 12.0)
    assert math.isclose(reg.reader("kernels_per_iter.host_bound").read(rec), 20.0)
    # 120 lane sweeps of 4 n^2 + 16 n bytes at 3.35 TB/s over 0.02 s.
    n = 9999
    assert math.isclose(reg.reader("gemv_f32_f64_roofline_pct.host_bound").read(rec),
                        100 * 120 * (4 * n * n + 16 * n) / HBM / 0.02)
    # The trace's launches are not the program's, or the program counts no
    # such launch or no iteration (an older commit), or there is no trace.
    rec.profiled.counters["gemv_launches_f32_f64"] = 119
    assert reg.reader("gemv_f32_f64_roofline_pct.host_bound").read(rec) is None
    bare = _record({"host_syncs": 5}, kernels)
    for name in ("iter_ms", "kernels_per_iter", "gemv_f32_f64_roofline_pct"):
        assert reg.reader(f"{name}.host_bound").read(bare) is None
    bare.trace = None
    assert reg.reader("kernels_per_iter.host_bound").read(bare) is None


def test_the_share_stays_under_the_bound_at_the_kernels_best():
    """At the least time the bytes allow, the share reads 100%, not more."""
    n = 9999
    least = 7 * (4 * n * n + 16 * n) / HBM
    rec = _record({"mprgp_iters": 7, "gemv_launches_f32_f64": 7}, {GEMV64: (least, 7)})
    assert math.isclose(Registry().reader("gemv_f32_f64_roofline_pct.host_bound").read(rec),
                        100.0)


class _Limits(Registry):
    def checks(self, cell):
        return {"x_gap_max": {"limit": 1e-4}}


def test_a_tiny_traced_run_reads_the_loops_counters(monkeypatch):
    """The cell at n = 24, 8 lanes, through the harness on the CPU: it is
    correct, and the window's counters give ``iter_ms`` and the host syncs;
    device numbers need the card's trace and are left out.  (This suite
    loads JAX for its parity tests, so the harness's import guard, which
    ``qpbench/tests`` holds, is stood down here.)"""
    monkeypatch.setattr(guard, "forbidden_loaded", lambda: [])
    result, _ = harness.run_cell(CELL, 2**31 + 21, 0.5, True, device="cpu",
                                 registry=_Limits(), shrink={"n": 24, "lanes": 8})
    assert result["correct"] and result["failed"] == 0
    assert result["metrics"]["iter_ms.host_bound"]["value"] > 0
    assert result["metrics"]["host_syncs_per_call.host_bound"]["value"] > 0
    assert not {"kernels_per_iter.host_bound", "gemv_f32_f64_roofline_pct.host_bound",
                "device_idle_pct.host_bound"} & set(result["metrics"])


@pytest.mark.parametrize("name", ["iter_ms.host_bound", "kernels_per_iter.host_bound",
                                  "gemv_f32_f64_roofline_pct.host_bound"])
def test_the_new_metrics_list_only_this_cell(name):
    spec = Registry().spec
    m = next(m for m in spec["per_layer"] if m["name"] == name)
    assert m["workloads"] == [CELL] and m["moves"] == "solves_per_s.host_bound"
