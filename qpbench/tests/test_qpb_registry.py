"""BENCHMARK.json against the contract, and every name found as a file."""
import json
import math
import re
import shutil

import pytest

from qpbench import harness, trace
from qpbench.registry import ROOT, Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["qpbench"]
    assert SPEC["command"][0] == "python3" and len(SPEC["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert (ROOT / SPEC["command"][1]).is_file()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_cells_and_metrics_follow_the_rules():
    reg = Registry()
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"qpbench/configs/{c['name']}.json"
        cfg = reg.config(c["name"])
        # What was cut from the source: keys, the same in both files.
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(one_line(k, 64) and NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = reg.mix(w["traffic"])
        assert (ROOT / "qpbench" / "entries" / f"{mix['entry']}.py").is_file()
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    seen = set()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    assert "workloads" not in next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in SPEC[group]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["name"] not in seen
            seen.add(m["name"])
            assert set(m.get("workloads", cells)) <= cells
            stem = m["name"].rsplit(".", 1)[0]
            assert any((ROOT / "qpbench" / "metrics" / f"{f}.py").is_file()
                       for f in (m["name"], stem))
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and one_line(m["layer"])
                moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
                assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert "setup_s" in {m["name"] for m in reg.metrics(cell, False)}
        assert len(reg.metrics(cell, False)) >= 2 and reg.metrics(cell, True)


def test_registry_finds_every_file_by_name():
    reg = Registry()
    for w in SPEC["workloads"]:
        mix = reg.mix(w["traffic"])
        entry = reg.entry(mix["entry"])
        assert callable(entry.prepare) and callable(entry.call)
        assert reg.config(w["config"])["name"] == w["config"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(reg.reader(m["name"]).read)
    with pytest.raises(KeyError):
        reg.workload("no.such.cell")
    with pytest.raises(FileNotFoundError):
        reg.mix("no_such_mix")


def test_a_split_metric_reads_with_its_stems_reader_unless_it_has_its_own(tmp_path):
    shutil.copytree(ROOT / "qpbench", tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    reg = Registry(root=tmp_path)
    stem = reg.reader("call_ms_p95")
    assert reg.reader("call_ms_p95.host_bound").read.__code__.co_code == stem.read.__code__.co_code
    (tmp_path / "qpbench" / "metrics" / "call_ms_p95.own.py").write_text(
        "def read(rec):\n    return -1.0\n")
    assert reg.reader("call_ms_p95.own").read(None) == -1.0
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric.host_bound")


#: A throwaway counter reader and per-kernel reader, added as files.
SYNC_READER = """def read(rec):
    c = rec.window.counters
    return None if c is None else float(c["host_syncs"])
"""
KERNEL_READER = """def read(rec):
    if rec.trace is None:
        return None
    return 1e3 * sum(s for k, s in rec.trace.kernel_s.items() if "apgd_sc_step" in k)
"""


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path, tiny, monkeypatch):
    """A throwaway mix (the box iterative path at another phase-1 budget and
    bucket, and metrics of its own: a count of calls, a reader of the
    program's counters and one of a kernel's device time) runs through the
    unchanged harness from a copy of the benchmark that only gains files
    and entries."""
    shutil.copytree(ROOT / "qpbench", tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "qpbench" / "mixes" / "iterative.json").read_text())
    mix.update(name="throwaway", phase1=7, bucket=4)
    (tmp_path / "qpbench" / "mixes" / "throwaway.json").write_text(json.dumps(mix))
    metrics = tmp_path / "qpbench" / "metrics"
    (metrics / "bucket_calls.py").write_text(
        "def read(rec):\n    return float(len(rec.window.walls))\n")
    (metrics / "window_syncs.py").write_text(SYNC_READER)
    (metrics / "step_kernel_ms.py").write_text(KERNEL_READER)
    spec["workloads"].append({"name": "box1000.throwaway", "config": "box1000",
                              "traffic": "throwaway", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("box1000.throwaway")
    for name, source in (("bucket_calls", "host_clock"), ("window_syncs", "program_counter"),
                         ("step_kernel_ms", "device_trace")):
        spec["per_layer"].append({"name": name, "unit": "x", "better": "higher",
                                  "source": source, "layer": "caller", "moves": "solves_per_s",
                                  "workloads": ["box1000.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(root=tmp_path)
    result, _ = harness.run_cell("box1000.throwaway", 5, 0.2, False, device="cpu",
                                 registry=reg, shrink=tiny)
    assert set(result["metrics"]) == {"solves_per_s", "setup_s"}
    result, _ = harness.run_cell("box1000.throwaway", 5, 0.2, True, device="cpu",
                                 registry=reg, shrink=tiny)
    assert result["metrics"]["bucket_calls"]["value"] >= 1
    assert result["metrics"]["window_syncs"]["value"] >= 1
    # The CPU has no device trace: the kernel's reader finds nothing, and the
    # metric is left out.  Given a trace that holds the kernel, it reads.
    assert "step_kernel_ms" not in result["metrics"]
    host = [("qpbench.call", 0.0, 1.0), ("qpbench.fetch", 1.0, 1.1)]
    dev = [("void apgd_sc_step_kernel<float>", 0.2, 0.25), ("add", 0.3, 0.4)]
    monkeypatch.setattr(trace, "profiler_events", lambda events: (dev, host))
    result, _ = harness.run_cell("box1000.throwaway", 5, 0.2, True, device="cpu",
                                 registry=reg, shrink=tiny)
    assert math.isclose(result["metrics"]["step_kernel_ms"]["value"], 50.0)
