"""What the tests of ``ccqppy_tpu_torch.bench`` and
``ccqppy_tpu_torch.benchmarks`` share: the numpy ensembles both packages
solve, the JAX runs' result keys (read from the JAX package's committed
results, never written), and the per-lane comparison."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_RESULTS = ROOT / "benchmarks" / "results"


def family(seed, B, n, scale=1.0, boost=1.0, dtype=np.float64):
    """``A = G G^T + boost n I`` in ``dtype``, ``b = -A x_uncon`` in f64 with
    ``x_uncon ~ U(-scale, scale)``: the studies' family, drawn with numpy."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = (G @ G.transpose(0, 2, 1) + boost * n * np.eye(n)).astype(dtype)
    return A, -np.einsum("bij,bj->bi", A.astype(np.float64), rng.uniform(-scale, scale, (B, n)))


def jax_keys(name):
    """The keys of a JAX study's committed result ``benchmarks/results/name``."""
    return json.loads((JAX_RESULTS / name).read_text())


def jax_bench_keys():
    """The keys of the JSON line of the JAX package's root ``bench.py``: the
    string keys of the dict it assigns to ``result``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py assigns no dict to result")


def assert_has_keys(got, want, where):
    """``got`` holds every key of ``want`` (a dict or key list); nested dicts
    and lists of dicts are compared the same way, element by element (an
    element past the end of ``want``'s list against its last)."""
    keys = list(want)
    missing = [k for k in keys if k not in got]
    assert not missing, f"{where}: missing JAX keys {missing}"
    if isinstance(want, dict):
        for k, v in want.items():
            if isinstance(v, dict):
                assert_has_keys(got[k], v, f"{where}.{k}")
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                for i, item in enumerate(got[k]):
                    assert_has_keys(item, v[min(i, len(v) - 1)], f"{where}.{k}[{i}]")


def assert_card_stamp(payload):
    assert payload["card"] == {"device": "cpu", "name": "cpu", "nvidia_smi": None}


def assert_lanes_match(rj, rt, atol):
    """Per lane: equal ``converged`` and matvec counts, x within ``atol``."""
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=atol)


def assert_needs_a_card(cli):
    """Without ``--device cpu`` an entry raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["--out", "unused"])
