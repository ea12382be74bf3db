"""Whole runs at tiny sizes on the CPU (the harness's test hook skips the
look for a card), the command line without a card, the control and the
faults that ``correct`` has to catch, the sweeps the counts reckon, and the
import check."""
import ast
import dataclasses
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from qpbench import guard, harness
from qpbench.reference import control
from qpbench.registry import ROOT, Registry

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 77


class TinyLimits(Registry):
    """The cells' files, with an x_gap limit for tiny sizes (the cells'
    own limits are read at the published sizes on the card)."""

    def checks(self, cell):
        return {"x_gap_max": {"limit": 1e-4}}


def run(cell, tiny, traced=False, entry=None, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, traced, device="cpu", registry=TinyLimits(),
                            shrink=tiny, entry=entry)


def broken(check):
    """True when a compared number reads above its limit."""
    return any(c["value"] > c["limit"] for c in check.values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_is_correct_and_prints_the_contracts_line(cell, tiny, capsys):
    result, lines = run(cell, tiny)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    reg = Registry()
    assert set(result["metrics"]) == {m["name"] for m in reg.metrics(cell, False)} - \
        {"peak_mem_gib"}          # no device memory on the CPU
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == {"residual_max", "x_gap_max"}
    harness.emit(result, lines)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert err.strip().splitlines()[-2].startswith("residual_max ")
    assert err.strip().splitlines()[-1].startswith("x_gap_max ")


def test_a_traced_run_reads_the_counts_and_leaves_device_numbers_out(tiny):
    result, _ = run("box1000.iterative", tiny, traced=True)
    assert result["correct"]
    # Counts come from the program; device numbers need the card's trace.
    assert {"matvecs_per_solve", "phase2_lanes_pct"} <= set(result["metrics"])
    assert not {"device_idle_pct", "gemv_roofline_pct", "sweep_bw_pct"} & set(result["metrics"])
    assert "busy_s" not in result["device"]


def test_the_command_line_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "qpbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert p.returncode == 2 and p.stdout == "" and "CUDA" in p.stderr


@pytest.mark.parametrize("cell", ["box1000.iterative", "cone999.apgd_sc"])
def test_the_tf32_control_is_refused(cell, tiny):
    result, _ = run(cell, tiny, entry=control)
    assert not result["correct"] and result["failed"] > 0
    assert result["checks"]["residual_max"]["value"] > 3 * result["checks"]["residual_max"]["limit"]


def _faulty_solver(fn, fault):
    def solve(A, b, x0=None, proj=None, **kw):
        if fault == "unchanged":
            r = fn(A, b, x0=x0, proj=proj, **kw)
            return dataclasses.replace(r, x=x0.clone())
        if fault == "half":
            h = b.shape[0] // 2
            take = A[:h] if isinstance(A, torch.Tensor) else A.take(torch.arange(h))
            r = fn(take, b[:h], x0=None if x0 is None else x0[:h], proj=proj, **kw)
            full = fn(A, b, x0=x0, proj=proj, **kw)
            x = torch.cat([r.x, x0[h:]])
            return dataclasses.replace(full, x=x)
        r = fn(A, b, x0=x0, proj=proj, **kw)
        x = r.x.clone()
        x[:, 0] += 1e-2
        return dataclasses.replace(r, x=x)
    return solve


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_refused(cell, fault, tiny, monkeypatch):
    """The solver under the entry broken three ways: its steps leave the
    state as it was; half the lanes left unsolved (their start returned as
    the answer); an answer altered where it is produced.  (There is no
    exchange between cards in a one-card cell.)"""
    from ccqppy_tpu_torch.models import SOLVERS

    for name, (fn, cfg) in list(SOLVERS.items()):
        monkeypatch.setitem(SOLVERS, name, (_faulty_solver(fn, fault), cfg))
    # The direct path's first step is its inverse apply: left undone, its
    # state is the start P(0), for every lane or for half of them.
    entry = Registry().entry("direct")
    real = entry.direct_x0

    def direct_x0(Ainv, b, proj):
        x = real(Ainv, b, proj)
        start = proj.project(torch.zeros_like(b))
        if fault == "unchanged":
            return start
        if fault == "half":
            return torch.cat([x[:b.shape[0] // 2], start[b.shape[0] // 2:]])
        return x

    monkeypatch.setattr(entry, "direct_x0", direct_x0)
    # A window of several calls: in one call the sample can miss the half
    # of the lanes that was left out.
    result, _ = run(cell, tiny, seconds=1.0)
    assert not result["correct"] and broken(result["checks"]) and result["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_counted_sweeps_never_exceed_the_lanes_the_gemv_is_handed(cell, tiny, monkeypatch):
    """Each lane's reported matvecs plus the entry's uncounted sweeps (the
    numerator of ``sweep_bw_pct`` and ``gemv_roofline_pct``) against the
    lanes ``ops.gemv.batched_gemv`` is handed in the calls."""
    import ccqppy_tpu_torch.models.direct as direct_mod
    import ccqppy_tpu_torch.ops.gemv as gemv_mod
    import ccqppy_tpu_torch.ops.linop as linop_mod

    reg = Registry()
    w = reg.workload(cell)
    cfg, mix = harness._shrunk(reg.config(w["config"]), reg.mix(w["traffic"]), tiny)
    entry = reg.entry(mix["entry"])
    from qpbench import traffic
    A, b0, _ = traffic.ensemble(cfg, mix["lanes"], SEED, torch.device("cpu"))
    state = entry.prepare(SimpleNamespace(A=A, b0=b0, config=cfg, device=torch.device("cpu")), mix)
    handed = []
    real = gemv_mod.batched_gemv

    def counting(Am, x):
        handed.append(x.shape[0])
        return real(Am, x)

    for mod in (gemv_mod, linop_mod, direct_mod):
        monkeypatch.setattr(mod, "batched_gemv", counting)
    counted = 0
    for k in range(4):
        r = entry.call(state, traffic.call_rhs(b0, SEED, k, mix["noise"]))
        counted += int(r.matvecs.sum()) + entry.UNCOUNTED_SWEEPS * r.matvecs.shape[0]
    assert 0 < counted <= sum(handed)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_file_imports_jax_and_only_the_entries_import_the_program():
    bench = ROOT / "qpbench"
    for path in bench.rglob("*.py"):
        tops = {guard.top_level(n) for n in _imports(path)}
        assert not tops & guard.FORBIDDEN, path
        rel = path.relative_to(bench).parts
        if "ccqppy_tpu_torch" in tops:
            assert rel[0] in ("entries", "tests"), path
        if rel[0] == "reference":
            assert not {n for n in _imports(path) if n.startswith("qpbench.entries")}, path


def test_the_run_checks_what_is_loaded(tiny, monkeypatch):
    assert guard.forbidden_loaded(["ccqppy_tpu_torch.ops", "numpy"]) == []
    assert guard.forbidden_loaded(["ccqppy_tpu.models", "jax.numpy", "jaxlib"]) == \
        ["ccqppy_tpu", "jax", "jaxlib"]
    monkeypatch.setitem(sys.modules, "ccqppy_tpu", sys.modules["json"])
    with pytest.raises(harness.ForbiddenImport, match="ccqppy_tpu"):
        run(CELLS[0], tiny)


def test_the_window_keeps_the_programs_counter_gains(tiny):
    """The window's ``host_syncs`` gain is the program counter's own gain
    over the window's calls; the control, which has no counters, keeps
    None."""
    from ccqppy_tpu_torch.models import base

    real = Registry().entry("fused_compact")
    gains = []

    def call(state, b):
        before = base.HOST_SYNCS
        r = real.call(state, b)
        gains.append(base.HOST_SYNCS - before)
        return r

    entry = SimpleNamespace(prepare=real.prepare, call=call, counters=real.counters,
                            UNCOUNTED_SWEEPS=real.UNCOUNTED_SWEEPS)
    keep = []
    result, _ = harness.run_cell("box1000.iterative", SEED, 0.3, False, device="cpu",
                                 registry=TinyLimits(), shrink=tiny, entry=entry, keep=keep)
    rec = keep[0]
    assert result["correct"] and len(gains) == len(rec.window.walls) + 1   # the warm-up
    assert rec.window.counters["host_syncs"] == sum(gains[1:]) > 0
    # No GEMV kernel and no fused step on the CPU.
    assert rec.window.counters["gemv_launches"] == rec.window.counters["gemv_lanes_swept"] == 0
    keep = []
    harness.run_cell("box1000.iterative", SEED, 0.3, True, device="cpu", registry=TinyLimits(),
                     shrink=tiny, entry=control, keep=keep)
    assert keep[0].window.counters is None and keep[0].profiled.counters is None
