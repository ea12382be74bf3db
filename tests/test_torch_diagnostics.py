"""Diagnostics (``utils.diagnostics``) against the JAX package's on the same
inputs, in f64 on the CPU: ``check_result``'s report, ``trim_trace``'s
per-lane histories, ``timed_solve`` and ``profile_solve``."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.parallel import solve_batched as jax_solve_batched
from ccqppy_tpu.utils import diagnostics as jdiag
from ccqppy_tpu.utils import problems as jproblems
from ccqppy_tpu.utils.random_qp import random_qp_batch as jax_random_qp_batch
from ccqppy_tpu_torch.models import BBPGDConfig, MPRGPConfig, bbpgd, mprgp
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import solve_batched
from ccqppy_tpu_torch.utils import diagnostics, problems

torch.set_num_threads(1)

REPORT_KEYS = ["finite_x", "finite_residual", "feasible", "infeasible_lanes",
               "residual_rel_err", "residual_consistent", "ok"]


def _box_pair():
    jp, tp = jproblems.box_constrained_spd(), problems.box_constrained_spd(device="cpu")
    rj = cq.models.bbpgd.solve(jp.A, jp.b, proj=jp.proj, config=cq.models.BBPGDConfig(tol=1e-10))
    rt = bbpgd.solve(tp.A, tp.b, proj=tp.proj, config=BBPGDConfig(tol=1e-10))
    return jp, tp, rj, rt


def test_check_result_passes_as_jax():
    jp, tp, rj, rt = _box_pair()
    rep_j = jdiag.check_result(rj, proj=jp.proj, A=jp.A, b=jp.b)
    rep_t = diagnostics.check_result(rt, proj=tp.proj, A=tp.A, b=tp.b)
    assert list(rep_t) == list(rep_j) == REPORT_KEYS
    for k in REPORT_KEYS:
        if k != "residual_rel_err":
            assert rep_t[k] == rep_j[k], k
    assert rep_t["ok"] and rep_t["feasible"] and rep_t["residual_consistent"]
    np.testing.assert_allclose(rep_t["residual_rel_err"], rep_j["residual_rel_err"],
                               rtol=0, atol=1e-6)
    # One (n, n) matrix shared by the lanes gives the same report.
    assert diagnostics.check_result(rt, proj=tp.proj, A=tp.A[0], b=tp.b) == rep_t


def test_check_result_fails_as_jax():
    """JAX's failing case: NaN in x (tests/test_diagnostics.py)."""
    jp, tp, rj, rt = _box_pair()
    bad_j = dataclasses.replace(rj, x=rj.x.at[0].set(jnp.nan))
    x = rt.x.clone()
    x[0, 0] = torch.nan
    bad_t = dataclasses.replace(rt, x=x)
    rep_j = jdiag.check_result(bad_j, proj=jp.proj, raise_on_fail=False)
    rep_t = diagnostics.check_result(bad_t, proj=tp.proj, raise_on_fail=False)
    assert rep_t == rep_j
    assert not rep_t["ok"] and rep_t["infeasible_lanes"] == [0]
    with pytest.raises(AssertionError, match="SolveResult check failed"):
        diagnostics.check_result(bad_t, proj=tp.proj)
    # A residual that disagrees with (A, b) fails the consistency check.
    off = dataclasses.replace(rt, residual=rt.residual + 1.0)
    rep = diagnostics.check_result(off, proj=tp.proj, A=tp.A, b=tp.b, raise_on_fail=False)
    assert not rep["residual_consistent"] and not rep["ok"]


@pytest.mark.parametrize("case", ["bbpgd", "mprgp"])
def test_trim_trace_lengths_match_jax(case):
    if case == "bbpgd":
        jp, tp = jproblems.box_constrained_spd(), problems.box_constrained_spd(device="cpu")
        jsolve, tsolve = cq.models.bbpgd.solve, bbpgd.solve
        jcfg, cfg = (cq.models.BBPGDConfig(tol=1e-10, max_matvecs=1000, trace_len=64),
                     BBPGDConfig(tol=1e-10, max_matvecs=1000, trace_len=64))
    else:
        jp = jproblems.active_box_constrained_spd()
        tp = problems.active_box_constrained_spd(device="cpu")
        jsolve, tsolve = cq.models.mprgp.solve, mprgp.solve
        jcfg, cfg = (cq.models.MPRGPConfig(tol=1e-10, max_matvecs=1000, trace_len=64),
                     MPRGPConfig(tol=1e-10, max_matvecs=1000, trace_len=64))
    rj = jsolve(jp.A, jp.b, proj=jp.proj, config=jcfg)
    rt = tsolve(tp.A, tp.b, proj=tp.proj, config=cfg)
    hj, (ht,) = jdiag.trim_trace(rj), diagnostics.trim_trace(rt)
    assert len(ht) == len(hj) == int(rt.iterations[0])
    np.testing.assert_allclose(ht, hj, rtol=1e-8, atol=1e-14)
    # MPRGP starts at the optimum's corner: no iteration, an empty history.
    assert len(ht) == 0 if case == "mprgp" else ht[-1] < 1e-10 < ht[0]


def test_trim_trace_batch_matches_jax():
    """A batch of 8 (JAX's test_trace_in_batched_solve, its ensemble)."""
    As, bs, _ = jax_random_qp_batch(jax.random.PRNGKey(0), 8, 16, jnp.float64, diag_boost=1.0)
    jproj = cq.box(-jnp.ones(16, jnp.float64), jnp.ones(16, jnp.float64), jnp.float64)
    rj = jax_solve_batched("bbpgd", As, bs, proj=jproj,
                           config=cq.models.BBPGDConfig(tol=1e-9, max_matvecs=1000,
                                                        trace_len=32))
    rt = solve_batched("bbpgd", torch.tensor(np.asarray(As)), torch.tensor(np.asarray(bs)),
                       proj=box(-torch.ones(16), torch.ones(16), torch.float64),
                       config=BBPGDConfig(tol=1e-9, max_matvecs=1000, trace_len=32))
    hj, ht = jdiag.trim_trace(rj), diagnostics.trim_trace(rt)
    assert len(ht) == len(hj) == 8
    assert [len(h) for h in ht] == [len(h) for h in hj]
    for h, it in zip(ht, rt.iterations.tolist()):
        assert len(h) == min(it, 32)


def test_timed_solve_fills_every_lane():
    tp = problems.box_constrained_spd(device="cpu")
    A, b = tp.A.expand(3, 3, 3), tp.b.expand(3, 3)
    r = diagnostics.timed_solve(bbpgd.solve, A, b, proj=tp.proj, config=BBPGDConfig(tol=1e-10))
    assert r.solve_time.shape == (3,) and r.solve_time.dtype == torch.float64
    assert bool((r.solve_time > 0).all()) and len(set(r.solve_time.tolist())) == 1
    assert bool(r.converged.all())


def test_profile_solve_writes_a_trace(tmp_path):
    tp = problems.box_constrained_spd(device="cpu")
    with diagnostics.profile_solve(tmp_path / "trace") as prof:
        bbpgd.solve(tp.A, tp.b, proj=tp.proj, config=BBPGDConfig(tol=1e-10))
    path = tmp_path / "trace" / diagnostics.TRACE_FILE
    assert path.exists() and os.path.getsize(path) > 0
    assert len(prof.key_averages()) > 0


@pytest.mark.cuda
def test_check_result_on_cuda(tmp_path):
    """A CUDA result: the report as on the CPU; with TF32 on an f32 audit
    raises; profile_solve records CUDA kernel events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccqppy_tpu_torch.ops import gemv
    dev = torch.device("cuda", 0)
    tp = problems.box_constrained_spd(torch.float32, dev)
    before = gemv.LAUNCHES
    with diagnostics.profile_solve(tmp_path) as prof:
        r = bbpgd.solve(tp.A, tp.b, proj=tp.proj, config=BBPGDConfig(tol=1e-6))
    assert gemv.LAUNCHES > before
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    assert any("gemv" in n for n in names), names
    assert (tmp_path / diagnostics.TRACE_FILE).exists()
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        rep = diagnostics.check_result(r, proj=tp.proj, A=tp.A, b=tp.b)
        assert rep["ok"] and rep["residual_consistent"]
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            diagnostics.check_result(r, proj=tp.proj, A=tp.A, b=tp.b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
