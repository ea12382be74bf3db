"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them sits in a file of its own, found by
name under the benchmark's folder:

* ``configs/<config>.json``: the problem ensemble (sizes, draws, set, tol,
  budget, dtype, the guarantee);
* ``mixes/<traffic>.json``: the call stream (entry, lanes a call, noise,
  the entry's parameters, the sample the check takes);
* ``entries/<entry>.py``: the call path, ``prepare(inputs, mix)`` and
  ``call(state, b)``, and optionally ``counters()``, the program's
  counters as they stand (``entries/_program.counters``), whose gains over
  each stretch of calls the record keeps; the only files that import the
  program;
* ``metrics/<metric>.py``: one reader per metric, ``read(record)``, which
  returns None where it finds nothing to read; a metric split by cells
  (``solves_per_s.host_bound``) shares its stem's.  Besides the calls'
  walls and matvecs, a reader finds the counters' gains in
  ``rec.window.counters`` (and ``rec.profiled.counters``), and in a traced
  run each kernel's device seconds and launches by name
  (``rec.trace.kernel_s``, ``rec.trace.kernel_launches``), the merged
  intervals of each of the program's spans (``rec.trace.spans``) and the
  device's idle intervals (``rec.trace.idle``); ``trace.merged`` and
  ``trace.overlap`` combine them, ``counts`` holds the bytes and FLOPs;
* ``checks/<cell>.json``: the limits of the numbers the check compares
  that the configuration does not state itself.

A configuration's file states what was cut from its source in ``reduced``
(keys, as in ``BENCHMARK.json``).  Adding a configuration, its cells, its
counters, its spans and its kernels' rooflines adds files and entries; no
file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

#: The benchmark's folder and the checkout's root.
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    """The benchmark definition rooted at ``root`` (a checkout's root, which
    holds ``BENCHMARK.json`` and the benchmark's folder ``folder``)."""

    def __init__(self, root=ROOT, folder=HERE.name):
        self.root = Path(root)
        self.dir = self.root / folder
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.spec["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def _json(self, kind, name):
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} file {path}")
        return json.loads(path.read_text())

    def config(self, name):
        return self._json("configs", name)

    def mix(self, name):
        return self._json("mixes", name)

    def checks(self, cell):
        """The cell's limits file, or {} when the cell has none."""
        path = self.dir / "checks" / f"{cell}.json"
        return json.loads(path.read_text()) if path.is_file() else {}

    def entry(self, name):
        return load_module(self.dir / "entries" / f"{name}.py", f"qpbench_entry_{name}")

    def reader(self, metric):
        """``metrics/<metric>.py``; a metric split by its cells,
        ``<name>.<group>``, reads with ``metrics/<name>.py`` unless it has a
        file of its own."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = self.dir / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
        return load_module(path, f"qpbench_metric_{metric}")

    def metrics(self, cell, traced):
        """The metrics the cell reports: its end-to-end ones untraced, its
        per-layer ones traced.  A metric without ``workloads`` is every
        cell's."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(path, name):
    """Import the file ``path`` as module ``name`` (names may hold dots, so
    files are loaded by path, not by import name)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no such file {path}")
    key = f"{name.replace('.', '_')}_{abs(hash(str(path.resolve()))) % 10**8}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
