"""The ill-conditioned study (``ccqppy_tpu_torch.benchmarks.benchmark_illcond``)
against the JAX package's ``benchmarks/benchmark_illcond.py``: plain PCG
on the f32 stack and rr-PCG on ``MixedPrecDense(A, A_bf16)`` (refresh 16
and 32, the script's ``segment_drop``), from the Jacobi start, on one numpy
ensemble per family, with f64 iterates on the CPU (the setting of
``tests/test_torch_mixed.py``), at the study's tol 2e-5.

Plain PCG matches per lane on every family: counts, ``converged``, x to
1e-10.  rr-PCG does on a well-conditioned family (boost 0.5, condition
~10), as in ``tests/test_torch_mixed.py``.  On the study's families
(condition ~40-200) rr-PCG's trajectories part between the packages: they
sum the bf16 sweeps in other orders, an x that rounds to bf16 on the other
side of a half-way point changes a cheap sweep, and the refreshes then
take other paths (counts apart by up to 7 of ~60-130 matvecs, x by up to
3.8e-5, seen at n=48).  There the tests hold the guarantee, as
``tests/test_torch_f64.py`` does for the f64 rung: every lane converges in
both, the port's fresh f64 residual is under tol, and x lies within
2 * 3n tol / lambda_min of JAX's.
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
from ccqppy_tpu_torch.benchmarks import benchmark_illcond as ic
from ccqppy_tpu_torch.benchmarks.common import audit_residual
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import prepare_dense_batch

torch.set_num_threads(1)

B, N = 6, 48
XTOL = 1e-10


def jax_run(jop_of, A, A16, b, x0, jcfg):
    """The JAX script's ``run_plain`` / ``make_rr`` body: the vmapped solve."""
    jproj = JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    return jax.vmap(lambda a, a16, b_, x0_: jax_pcg_solve(jop_of(a, a16), b_, x0=x0_, proj=jproj,
                                                          config=jcfg))(A, A16, b, x0)


def both(boost):
    """Plain PCG and rr-PCG at each refresh, in both packages, on one numpy
    family: (A, b, [(JAX result, port result), ...]), plain first."""
    A, b = family(30, B, N, scale=1.5, boost=boost, dtype=np.float32)
    At, At16 = prepare_dense_batch(torch.from_numpy(A), torch.bfloat16)
    Aj = jnp.asarray(A)
    Aj16 = Aj.astype(jnp.bfloat16)
    x0 = np.clip(-b / np.diagonal(A, axis1=-2, axis2=-1), -1.0, 1.0)
    bt, x0t = torch.from_numpy(b), torch.from_numpy(x0)
    proj = box(-torch.ones(N), torch.ones(N), dtype=torch.float64)
    runs = [(jax_run(lambda a, _: JL.DenseOperator(a), Aj, Aj16, jnp.asarray(b), jnp.asarray(x0),
                     JaxPCGConfig(tol=ic.TOL, max_matvecs=ic.BUDGET)),
             ic.run_plain(At, bt, x0t, proj, PCGConfig(tol=ic.TOL, max_matvecs=ic.BUDGET)))]
    drop = ic.segment_drop(boost)
    for K in ic.REFRESH:
        runs.append((jax_run(JL.MixedPrecDense, Aj, Aj16, jnp.asarray(b), jnp.asarray(x0),
                             JaxPCGConfig(tol=ic.TOL, max_matvecs=ic.BUDGET, refresh_every=K,
                                          segment_drop=drop)),
                     ic.run_rr(At, At16, bt, x0t, proj,
                               PCGConfig(tol=ic.TOL, max_matvecs=ic.BUDGET, refresh_every=K,
                                         segment_drop=drop))))
    return A, b, runs


def test_plain_and_rr_match_jax_per_lane_where_well_conditioned():
    _, _, runs = both(0.5)
    for rj, rt in runs:
        assert bool(np.asarray(rj.converged).all())
        assert_lanes_match(rj, rt, XTOL)


@pytest.mark.parametrize("boost", [0.1, 0.02])
def test_study_families_match_plain_per_lane_and_rr_to_the_guarantee(boost):
    A, b, ((rj, rt), *rr) = both(boost)
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, XTOL)
    lam_min = np.linalg.eigvalsh(A.astype(np.float64))[:, 0]
    proj64 = box(-torch.ones(N), torch.ones(N), dtype=torch.float64)
    for rj, rt in rr:
        assert bool(np.asarray(rj.converged).all()) and bool(rt.converged.all())
        res = audit_residual(torch.from_numpy(A), torch.from_numpy(b), rt.x, proj64)
        assert bool((res <= ic.TOL).all()), res
        bound = 2 * 3 * N * ic.TOL / lam_min
        assert (np.abs(rt.x.numpy() - np.asarray(rj.x)).max(axis=1) <= bound).all()


def test_segment_drop_is_the_jax_scripts():
    """``benchmark_illcond.py:147``: min(0.5, 4e-3 (4 + boost) / max(boost, 1e-3))."""
    for boost, want in ((0.1, 0.164), (0.05, 0.324), (0.02, 0.5)):
        assert ic.segment_drop(boost) == pytest.approx(want, rel=1e-12)


def test_main_writes_the_jax_keys_with_a_card_stamp(tmp_path):
    p = ic.main(n=24, B=4, reps=2, boosts=[0.05], refresh=[16, 32], device="cpu", out=tmp_path)
    assert_has_keys(p, jax_keys("illcond.json"), "illcond")
    (row,) = p["rows"]
    assert [r["refresh_every"] for r in row["rr"]] == [16, 32]
    for r in (row["plain_f32"], *row["rr"]):
        assert r["converged"] == 1.0 and r["true_res_max"] <= ic.TOL * 1.05
    assert_card_stamp(p)


def test_cli_needs_a_card():
    assert_needs_a_card(ic.cli)
