"""The f64 probe (``ccqppy_tpu_torch.benchmarks.benchmark_f64_probe``)
against the JAX package's ``benchmarks/benchmark_f64_probe.py``: its solve
(PCG from x = 0, 800 matvecs) on one numpy f64 ensemble at both f64 rows'
tolerances, per lane, on the CPU; then ``main`` small, with the JAX keys
and the card stamp.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bench_cases import (assert_card_stamp, assert_has_keys, assert_lanes_match,
                                assert_needs_a_card, family, jax_keys)
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.models.pcg import solve as jax_pcg_solve
from ccqppy_tpu.ops import linop as JL
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu_torch.benchmarks import benchmark_f64_probe as fp
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box

torch.set_num_threads(1)

B, N = 8, 40


@pytest.mark.parametrize("tol", sorted({tol for dtype, tol in fp.ROWS if dtype == torch.float64}))
def test_f64_rows_match_jax(tol):
    A, b = family(40, B, N, scale=2.0)
    jproj = JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=tol, max_matvecs=fp.BUDGET)
    rj = jax.vmap(lambda A_, b_: jax_pcg_solve(JL.DenseOperator(A_), b_, proj=jproj,
                                               config=jcfg))(jnp.asarray(A), jnp.asarray(b))
    proj = box(-torch.ones(N), torch.ones(N), dtype=torch.float64)
    rt = fp.run_pcg(torch.from_numpy(A), torch.from_numpy(b), proj,
                    PCGConfig(tol=tol, max_matvecs=fp.BUDGET))
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, 1e-10)


def test_main_writes_the_jax_keys_with_a_card_stamp(tmp_path):
    p = fp.main(B=4, n=24, device="cpu", out=tmp_path)
    want = jax_keys("f64_probe.json")
    assert_has_keys(p, want, "f64_probe")
    assert [(r["dtype"], r["tol"]) for r in p["rows"]] == [
        (r["dtype"], r["tol"]) for r in want["rows"]]
    for r in p["rows"]:
        assert r["converged"] == 1.0 and r["true_residual_max"] <= r["tol"] * 1.05
    assert p["f64_over_f32_wall"] == p["rows"][1]["wall_s"] / p["rows"][0]["wall_s"]
    assert_card_stamp(p)


def test_cli_needs_a_card():
    assert_needs_a_card(fp.cli)
