"""The large-cone study (``ccqppy_tpu_torch.benchmarks.benchmark_large_cone``)
against the JAX package's ``benchmarks/benchmark_large_cone.py``, in f64 on
the CPU, at n=30 (10 Lorentz blocks) in place of 9999.

The JAX script solves one unbatched QP per solver; the port solves it as a
batch of one.  SPG's draws differ (the port's keys are
``split_keys(seed + 1, 1)``, JAX's default key ``PRNGKey(0)``), so the port
draws JAX's uniforms through ``draw=``.  Counts and ``converged`` match
exactly, x to 1e-10.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bench_cases import (assert_card_stamp, assert_has_keys, assert_needs_a_card,
                                family, jax_keys)
from ccqppy_tpu.models import SOLVERS as JAX_SOLVERS
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu_torch.benchmarks import benchmark_large_cone as lc
from ccqppy_tpu_torch.models import SOLVERS, spg
from ccqppy_tpu_torch.ops.projections import blockwise, lorentz_cone
from ccqppy_tpu_torch.utils.rng import split_keys
from test_torch_spg import draw_table

torch.set_num_threads(1)

N = 30
XTOL = 1e-10


@pytest.fixture(scope="module")
def problem():
    A, b = family(8, 1, N, scale=2.0)
    return A, b


@pytest.mark.parametrize("name", lc.SOLVER_NAMES)
def test_solver_matches_jax(problem, name, monkeypatch):
    A, b = problem
    fn, cfg_cls = JAX_SOLVERS[name]
    jproj = JP.blockwise(JP.lorentz_cone(lc.MU, jnp.float64), 3)
    rj = fn(jnp.asarray(A[0]), jnp.asarray(b[0]), proj=jproj,
            config=cfg_cls(tol=lc.TOL, max_matvecs=lc.BUDGET))
    pk = split_keys(lc.SEED + 1, 1)
    monkeypatch.setitem(SOLVERS, "spg", (partial(spg.solve, draw=draw_table(
        [(pk, jax.random.PRNGKey(0)[None])], lc.BUDGET)), spg.SPGConfig))
    proj = blockwise(lorentz_cone(lc.MU, torch.float64), 3)
    rt = lc.run_solver(name, torch.from_numpy(A), torch.from_numpy(b), proj)
    assert bool(rj.converged)
    assert bool(rt.converged[0]) == bool(rj.converged)
    assert int(rt.matvecs[0]) == int(rj.matvecs)
    np.testing.assert_allclose(rt.x[0].numpy(), np.asarray(rj.x), rtol=0, atol=XTOL)


def test_main_writes_the_jax_keys_with_a_card_stamp(tmp_path):
    p = lc.main(n=31, device="cpu", dtype=torch.float64, out=tmp_path)
    want = jax_keys("large_cone.json")
    assert_has_keys(p, want, "large_cone")
    assert p["n"] == 30 and [r["solver"] for r in p["rows"]] == list(lc.SOLVER_NAMES)
    rows = {r["solver"]: r for r in p["rows"]}
    for r in rows.values():
        assert r["converged"] and r["true_residual"] <= lc.TOL * 1.05
        assert r["feasibility_gap"] < 1e-12
    assert rows["pcg"]["matvecs"] == rows["mprgp_bb"]["matvecs"]
    assert_card_stamp(p)


def test_cli_needs_a_card():
    assert_needs_a_card(lc.cli)
