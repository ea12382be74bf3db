"""The port's headline entry ``ccqppy_tpu_torch.bench`` against the path of
the JAX package's ``bench.py``, in f64 on the CPU.

Its two modes are ``solve_batched_fused_compact("pcg", ...)`` from the
Jacobi start (iterative: phase 1 at 17, a 256-lane bucket) and from
``direct_x0`` of the inverse (direct: phase 1 at 3, a 64-lane bucket).
Both packages run each on one numpy ensemble and match per lane.  Then
``main`` runs small on the CPU: its line carries the JAX line's keys and
the card stamp, and passes its own f64 audit.
"""
import json

import numpy as np
import torch

import jax.numpy as jnp

from _torch_bench_cases import (assert_card_stamp, assert_lanes_match, assert_needs_a_card,
                                family, jax_bench_keys)
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.models.direct import direct_x0 as jax_direct_x0
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel import solve_batched_fused_compact as jax_fused
from ccqppy_tpu_torch import bench
from ccqppy_tpu_torch.models.direct import spd_inverse_batch
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box

torch.set_num_threads(1)

B, N = 8, 40
XTOL = 1e-10


def _both(A, b):
    """(numpy A, b) as JAX and torch arrays, the box and config of each."""
    jproj = JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=bench.TOL, max_matvecs=bench.BUDGET)
    proj = box(-torch.ones(N), torch.ones(N), dtype=torch.float64)
    cfg = PCGConfig(tol=bench.TOL, max_matvecs=bench.BUDGET)
    return (jnp.asarray(A), jnp.asarray(b), jproj, jcfg,
            torch.from_numpy(A), torch.from_numpy(b), proj, cfg)


def test_iterative_mode_matches_jax():
    """A weak diagonal (condition ~80) and active bounds push some lanes past
    phase 1, so the bucket runs."""
    A, b = family(1, B, N, scale=3.0, boost=0.05)
    Aj, bj, jproj, jcfg, At, bt, proj, cfg = _both(A, b)
    diag = jnp.diagonal(Aj, axis1=-2, axis2=-1)
    rj = jax_fused("pcg", Aj, bj, bench.PHASE1, x0=jnp.clip(-bj / diag, -1.0, 1.0), proj=jproj,
                   config=jcfg, bucket=bench.BUCKET, host_fallback=False)
    rt = bench.run_iterative(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, cfg)
    assert bool(np.asarray(rj.converged).all())
    assert int(np.asarray(rj.matvecs).max()) > bench.PHASE1
    assert_lanes_match(rj, rt, XTOL)


def test_direct_mode_matches_jax():
    """The port's Cholesky inverse is the numpy inverse to rounding; both
    packages then start from ``direct_x0`` of that inverse."""
    A, b = family(2, B, N, scale=3.0)
    Aj, bj, jproj, jcfg, At, bt, proj, cfg = _both(A, b)
    Ainv = spd_inverse_batch(At)
    np.testing.assert_allclose(Ainv.numpy(), np.linalg.inv(A), rtol=0, atol=1e-14)
    rj = jax_fused("pcg", Aj, bj, bench.PHASE1_DIRECT,
                   x0=jax_direct_x0(jnp.asarray(Ainv.numpy()), bj, jproj), proj=jproj,
                   config=jcfg, bucket=bench.BUCKET_DIRECT, host_fallback=False)
    rt = bench.run_direct(Ainv, At, bt, proj, cfg)
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, XTOL)


def test_main_prints_the_jax_line_with_a_card_stamp(tmp_path, capsys):
    r = bench.main(B_iter=6, B_direct=4, n=24, pipeline=2, pipe_direct=2, device="cpu",
                   dtype=torch.float64, out=tmp_path)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == r == json.loads((tmp_path / "bench.json").read_text())
    assert list(bench.KEYS) == jax_bench_keys()
    assert list(r) == [*jax_bench_keys(), "card"]
    assert_card_stamp(r)
    assert "1 cpu" in r["metric"] and "TPU" not in r["metric"]
    assert r["convergence_rate"] == 1.0 and r["true_residual_max"] <= bench.TOL
    assert r["value"] > 0 and r["iterative_solves_per_s"] > 0
    assert r["vs_baseline"] == r["value"] / bench.REFERENCE_DIRECT_SOLVES_PER_S


def test_cli_needs_a_card():
    assert_needs_a_card(bench.cli)
