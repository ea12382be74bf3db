"""The whole slice at small size: the modes of the port wired exactly as
chip_smoke.py wires them, against the JAX package wired as bench.py (box
modes), benchmarks/benchmark_cone_ensemble.py (cone mode, its SPG row
included), the README's batched quick start (bbpgd_f mode),
``solve_batched_mixed`` (mixed mode) and benchmarks/benchmark_random_ccqp.py
(APGD-AR on the cone, classic APGD on the box) wire it, in f64 on the CPU,
per lane.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.models.direct import direct_x0 as jax_direct_x0
from ccqppy_tpu.models.direct import spd_inverse_batch as jax_spd_inverse_batch
from ccqppy_tpu.parallel import solve_batched_fused_compact as jax_fused_compact
from ccqppy_tpu_torch.utils import rng
from ccqppy_tpu_torch.utils.convert import (config_from_jax, problem_from_numpy,
                                            proj_from_jax)
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, N = 16, 128


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ensemble(seed):
    """bench.py's family: A = G G^T + n I, b = -A x_uncon, x_uncon ~ U(-1, 1),
    with the per-call 1e-3 N(0, 1) perturbation of b."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, N, N))
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (B, N)))
    return A, b + 1e-3 * rng.standard_normal((B, N))


def _setup(seed, cs):
    A, b = _ensemble(seed)
    jproj = cq.box(-jnp.ones(N), jnp.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=cs.TOL, max_matvecs=cs.BUDGET)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    return A, b, jproj, jcfg, At, bt, proj_from_jax(jproj), config_from_jax(jcfg)


def _assert_lanes_match(rj, rt, extra_matvecs=0):
    assert bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs) + extra_matvecs)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=1e-12)


def test_iterative_mode_matches_bench_wiring():
    cs = _chip_smoke()
    A, b, jproj, jcfg, At, bt, proj, cfg = _setup(41, cs)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    diag = jnp.diagonal(Aj, axis1=-2, axis2=-1)
    rj = jax_fused_compact("pcg", Aj, bj, cs.PHASE1, x0=jnp.clip(-bj / diag, -1.0, 1.0),
                           proj=jproj, config=jcfg, bucket=cs.BUCKET,
                           host_fallback=False)
    rt = cs.run_iterative(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, cfg)
    _assert_lanes_match(rj, rt)


def test_direct_mode_matches_bench_wiring():
    cs = _chip_smoke()
    A, b, jproj, jcfg, At, bt, proj, cfg = _setup(42, cs)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    Ainv_j = jax_spd_inverse_batch(Aj, chunk=128)
    rj = jax_fused_compact("pcg", Aj, bj, cs.PHASE1_DIRECT,
                           x0=jax_direct_x0(Ainv_j, bj, jproj), proj=jproj,
                           config=jcfg, bucket=cs.BUCKET_DIRECT, host_fallback=False)
    Ainv = cs.spd_inverse_batch(At)
    np.testing.assert_allclose(Ainv.numpy(), np.asarray(Ainv_j), rtol=1e-10, atol=1e-16)
    rt = cs.run_direct(Ainv, At, bt, proj, cfg)
    # bench.py calls the compacted PCG directly; solve_direct_batched adds
    # the inverse apply to each lane's count.
    _assert_lanes_match(rj, rt, extra_matvecs=1)


def test_audit_agrees_with_solver_residual():
    cs = _chip_smoke()
    cs.N = N
    A, b, jproj, jcfg, At, bt, proj, cfg = _setup(43, cs)
    rt = cs.run_iterative(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, cfg)
    np.testing.assert_allclose(cs.audit_residual(At, bt, rt.x).numpy(),
                               rt.residual.numpy(), rtol=1e-9, atol=1e-15)


B_CONE, N_CONE = 8, 99


def _cone_setup(seed, cs):
    """The cone benchmark's family at B=8, n=99 (33 Lorentz blocks, mu=1),
    its tol and budget, and b perturbed as per call."""
    from ccqppy_tpu.ops import projections as JP
    from ccqppy_tpu.ops.linop import estimate_spectral_bounds

    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B_CONE, N_CONE, N_CONE))
    A = G @ G.transpose(0, 2, 1) + N_CONE * np.eye(N_CONE)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (B_CONE, N_CONE)))
    b = b + 1e-3 * rng.standard_normal(b.shape)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    jproj = JP.blockwise(JP.lorentz_cone(1.0, dtype=jnp.float64), 3)
    diag = jnp.diagonal(Aj, axis1=-2, axis2=-1)
    jx0 = jax.vmap(jproj.project)(-bj / diag)
    At, bt = problem_from_numpy(A, b, "cpu", torch.float64)
    proj = cs.cone_proj(torch.float64)
    assert proj_from_jax(jproj).child.mu == proj.child.mu
    return Aj, bj, jproj, jx0, estimate_spectral_bounds(Aj), At, bt, proj


def test_cone_apgd_matches_benchmark_wiring():
    """Run (a) of the cone mode: the spectral prep and apgd_sc from the
    cone-Jacobi start, against the JAX package wired as
    benchmarks/benchmark_cone_ensemble.py wires it."""
    from ccqppy_tpu.models import APGDSCConfig as JaxAPGDSCConfig
    from ccqppy_tpu.ops.linop import SpectralDense as JaxSpectralDense
    from ccqppy_tpu.parallel import solve_batched as jax_solve_batched
    from ccqppy_tpu_torch.ops.linop import SpectralDense, estimate_spectral_bounds

    cs = _chip_smoke()
    Aj, bj, jproj, jx0, (Lj, muj), At, bt, proj = _cone_setup(51, cs)
    jcfg = JaxAPGDSCConfig(tol=cs.TOL_CONE, max_matvecs=cs.BUDGET_CONE)
    rj = jax_solve_batched("apgd_sc", JaxSpectralDense(Aj, Lj, muj), bj, x0=jx0,
                           proj=jproj, config=jcfg)
    L, mu = estimate_spectral_bounds(At, iters=32)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-12)
    rt = cs.run_cone_apgd(SpectralDense(At, L, mu), bt, proj, config_from_jax(jcfg))
    _assert_lanes_match(rj, rt)
    np.testing.assert_allclose(
        cs.audit_residual(At, bt, rt.x, proj).numpy(), rt.residual.numpy(),
        rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("phase1", [None, 30])
def test_cone_mprgp_compaction_matches_benchmark_wiring(phase1, monkeypatch):
    """Run (b) of the cone mode: fused MPRGP-BB with straggler compaction,
    at the mode's phase-1 budget and at one that leaves stragglers.  On the
    cone, x and the residual agree to 1e-8 (tests/test_torch_mprgp.py)."""
    from ccqppy_tpu.models import MPRGPBBConfig as JaxMPRGPBBConfig

    cs = _chip_smoke()
    if phase1 is not None:
        monkeypatch.setattr(cs, "PHASE1_CONE", phase1)
    Aj, bj, jproj, jx0, _, At, bt, proj = _cone_setup(52, cs)
    jcfg = JaxMPRGPBBConfig(tol=cs.TOL_CONE, max_matvecs=cs.BUDGET_CONE, fused=True)
    rj = jax_fused_compact("mprgp_bb", Aj, bj, cs.PHASE1_CONE, x0=jx0, proj=jproj,
                           config=jcfg, bucket=cs.BUCKET_CONE, host_fallback=False)
    rt = cs.run_cone_mprgp(At, bt, At.diagonal(dim1=-2, dim2=-1), proj,
                           config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    if phase1 is not None:
        assert int((np.asarray(rj.matvecs) > phase1).sum()) > 0      # stragglers
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=1e-8)


def test_bbpgd_f_mode_matches_readme_wiring():
    """Mode (e): ``solve_batched("bbpgd_f", ...)`` from the Jacobi start."""
    from ccqppy_tpu.models import BBPGDfConfig as JaxBBPGDfConfig
    from ccqppy_tpu.parallel import solve_batched as jax_solve_batched

    cs = _chip_smoke()
    A, b, jproj, _, At, bt, proj, _ = _setup(45, cs)
    jcfg = JaxBBPGDfConfig(tol=cs.TOL, max_matvecs=cs.BUDGET)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    diag = jnp.diagonal(Aj, axis1=-2, axis2=-1)
    rj = jax_solve_batched("bbpgd_f", Aj, bj, x0=jnp.clip(-bj / diag, -1.0, 1.0),
                           proj=jproj, config=jcfg)
    rt = cs.run_bbpgd_f(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, config_from_jax(jcfg))
    _assert_lanes_match(rj, rt)


def test_mixed_mode_matches_ladder_wiring():
    """Mode (f): the ladder on an f32 stack and its bf16 copy from
    ``prepare_dense_batch``, from the Jacobi start, f64 iterates; and the
    phase-A run that reads its per-lane matvecs."""
    from ccqppy_tpu.models import BBPGDfConfig as JaxBBPGDfConfig
    from ccqppy_tpu.ops.linop import CastDense as JaxCastDense
    from ccqppy_tpu.parallel import solve_batched as jax_solve_batched
    from ccqppy_tpu.parallel import solve_batched_mixed as jax_solve_batched_mixed

    cs = _chip_smoke()
    A, b = _ensemble(46)
    A = A.astype(np.float32)
    jproj = cq.box(-jnp.ones(N), jnp.ones(N), dtype=jnp.float64)
    jcfg = JaxBBPGDfConfig(tol=cs.TOL, max_matvecs=cs.BUDGET)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    Aj16 = Aj.astype(jnp.bfloat16)
    jx0 = jnp.clip(-bj / jnp.diagonal(Aj, axis1=-2, axis2=-1), -1.0, 1.0)
    rj = jax_solve_batched_mixed(Aj, bj, proj=jproj, config=jcfg, As_low=Aj16, x0=jx0)
    As, As16 = cs.prepare_dense_batch(torch.from_numpy(A), torch.bfloat16)
    bt, proj, cfg = torch.from_numpy(b), proj_from_jax(jproj), config_from_jax(jcfg)
    diag = As.diagonal(dim1=-2, dim2=-1)
    _assert_lanes_match(rj, cs.run_mixed(As, As16, bt, diag, proj, cfg))
    ra_j = jax_solve_batched("bbpgd_f", JaxCastDense(Aj16), bj, x0=jx0, proj=jproj,
                             config=JaxBBPGDfConfig(tol=cs.PHASE_A_TOL,
                                                    max_matvecs=cs.PHASE_A_BUDGET))
    ra = cs.run_phase_a(As16, bt, diag, proj, cfg)
    np.testing.assert_array_equal(ra.matvecs.numpy(), np.asarray(ra_j.matvecs))


def test_random_qp_batch_distribution():
    gen = torch.Generator().manual_seed(0)
    A, b, x = random_qp_batch(gen, 8, 64, torch.float64, diag_boost=1.0, chunk=3)
    assert A.shape == (8, 64, 64) and b.shape == (8, 64) and x.shape == (8, 64)
    np.testing.assert_allclose(A.numpy(), A.mT.numpy(), rtol=1e-13, atol=1e-10)
    d = A.diagonal(dim1=-2, dim2=-1)
    assert abs(float(d.mean()) - 2 * 64) < 0.05 * 2 * 64     # E[G G^T]_ii = n, + n
    assert float(x.abs().max()) <= 1.0
    np.testing.assert_allclose(b.numpy(), -np.einsum("bij,bj->bi", A.numpy(), x.numpy()),
                               rtol=1e-12, atol=1e-9)
    assert float(torch.linalg.eigvalsh(A).min()) >= 64 - 1e-9    # + n I: well conditioned
    A2, _, _ = random_qp_batch(torch.Generator().manual_seed(0), 8, 64, torch.float64,
                               diag_boost=1.0, chunk=3)
    assert torch.equal(A, A2)


@pytest.mark.cuda
def test_slice_on_cuda_matches_cpu_f64():
    """The port on the card in f32 (through the kernel) against the port on
    the CPU in f64, same problems."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    A, b, jproj, jcfg, At, bt, proj, cfg = _setup(44, cs)
    dev = torch.device("cuda", 0)
    r64 = cs.run_iterative(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, cfg)
    A32, b32 = At.float().to(dev), bt.float().to(dev)
    r32 = cs.run_iterative(A32, b32, A32.diagonal(dim1=-2, dim2=-1),
                           proj.to(dev).float(), cfg)
    assert bool(r32.converged.all())
    # Each solution is within ||g|| / lambda_min(A) <= 3 n tol / n = 3 tol
    # of the optimum (A = G G^T + n I), so the two are within 6 tol.
    np.testing.assert_allclose(r32.x.cpu().numpy(), r64.x.numpy(), rtol=0,
                               atol=6 * cs.TOL)


def _spg_draw(monkeypatch, pairs):
    """SPG in the batch entry points draws the JAX package's uniforms of
    ``pairs`` (port keys, JAX keys), keyed by the port's keys."""
    from functools import partial

    from ccqppy_tpu_torch.models import spg
    from ccqppy_tpu_torch.parallel import batch
    from test_torch_spg import draw_table

    monkeypatch.setitem(batch.SOLVERS, "spg",
                        (partial(spg.solve, draw=draw_table(pairs, 3000)), spg.SPGConfig))


def test_cone_spg_matches_benchmark_wiring(monkeypatch):
    """Mode (g): the benchmark's SPG row, from x = 0 with the keys of seed 1,
    uncompacted, then fused-compacted; phase 2 runs on fold_in(keys, 1) in
    both packages."""
    from ccqppy_tpu.models import SPGConfig as JaxSPGConfig
    from ccqppy_tpu.parallel import solve_batched as jax_solve_batched

    cs = _chip_smoke()
    Aj, bj, jproj, _, _, At, bt, proj = _cone_setup(53, cs)
    jcfg = JaxSPGConfig(tol=cs.TOL_CONE, max_matvecs=cs.BUDGET_CONE, criterion="eq25")
    jk = jax.random.split(jax.random.PRNGKey(cs.SEED_SPG), B_CONE)
    pk = cs.split_keys(cs.SEED_SPG, B_CONE)
    jk1 = jax.vmap(lambda k: jax.random.fold_in(k, 1))(jk)
    _spg_draw(monkeypatch, [(pk, jk), (rng.fold_in(pk, 1), jk1)])
    rj = jax_solve_batched("spg", Aj, bj, proj=jproj, config=jcfg, keys=jk)
    cfg = config_from_jax(jcfg)
    rt = cs.run_cone_spg(At, bt, proj, cfg, pk)
    _assert_cone_lanes_match(rj, rt)
    # The card's batch has a long tail past twice its p50; eight lanes have
    # none, so phase 1 here stops at the p50.
    phase1 = int(np.median(np.asarray(rj.matvecs)))
    rj = jax_fused_compact("spg", Aj, bj, phase1, proj=jproj, config=jcfg,
                           bucket=cs.BUCKET_CONE, keys=jk)
    rt = cs.run_cone_spg_compact(At, bt, proj, cfg, pk, phase1)
    assert int((np.asarray(rj.matvecs) > phase1).sum()) >= 1          # phase 2 ran
    _assert_cone_lanes_match(rj, rt)


def test_cone_apgd_ar_matches_study_wiring():
    """Mode (h): APGD-AR from the cone-Jacobi start, at the cone mode's tol
    and budget."""
    from ccqppy_tpu.models import APGDConfig as JaxAPGDConfig
    from ccqppy_tpu.parallel import solve_batched as jax_solve_batched

    cs = _chip_smoke()
    Aj, bj, jproj, jx0, _, At, bt, proj = _cone_setup(54, cs)
    jcfg = JaxAPGDConfig(tol=cs.TOL_CONE, max_matvecs=cs.BUDGET_CONE)
    rj = jax_solve_batched("apgd_ar", Aj, bj, x0=jx0, proj=jproj, config=jcfg)
    rt = cs.run_cone_apgd_ar(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, config_from_jax(jcfg))
    _assert_cone_lanes_match(rj, rt)


def test_box_apgd_mode_matches_study_wiring():
    """Mode (i): classic APGD from the Jacobi start at the study's budget."""
    from ccqppy_tpu.models import APGDConfig as JaxAPGDConfig
    from ccqppy_tpu.parallel import solve_batched as jax_solve_batched

    cs = _chip_smoke()
    A, b, jproj, _, At, bt, proj, _ = _setup(47, cs)
    jcfg = JaxAPGDConfig(tol=cs.TOL_APGD_BOX, max_matvecs=cs.BUDGET_APGD)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    diag = jnp.diagonal(Aj, axis1=-2, axis2=-1)
    rj = jax_solve_batched("apgd", Aj, bj, x0=jnp.clip(-bj / diag, -1.0, 1.0), proj=jproj,
                           config=jcfg)
    rt = cs.run_box_apgd(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, config_from_jax(jcfg))
    _assert_lanes_match(rj, rt)
    tot, most, batched = cs.apgd_trials(rt, 1 + 2 * int(rt.iterations.max()) + 5)
    assert most >= 0 and tot >= most and batched == 5


def test_readme_quick_start_in_f32():
    """The README's quick start as chip_smoke.py runs it, in f32 on the CPU:
    converged, x within 1e-4 of [1, 0, 1]."""
    cs = _chip_smoke()
    A, b, proj = cs.readme_qp("cpu")
    assert A.dtype == b.dtype == torch.float32 and A.shape == (1, 3, 3)
    r = cs.spg.solve(A, b, proj=proj, config=cs.SPGConfig(tol=1e-6, max_matvecs=5000))
    assert bool(r.converged.all())
    np.testing.assert_allclose(r.x.numpy(), [[1., 0., 1.]], atol=1e-4)


def _assert_cone_lanes_match(rj, rt):
    """Per lane on the cone: equal counts; x and the residual within 1e-8."""
    assert bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=0, atol=1e-8)


def test_reference_api_oracle_wiring():
    """(p) 1 on the CPU: the eight compat solvers on the six oracle problems
    in f64 and the compat docstring's example, each within 1e-5 of x* and
    audited by check_result; the default dtype is restored."""
    cs = _chip_smoke()
    saved = torch.get_default_dtype()
    rows = cs.run_oracle("cpu")
    assert torch.get_default_dtype() == saved
    assert len(rows) == 8 * 6 + 1
    assert {r[1] for r in rows} == {s.name for s in cs.compat_solvers("cpu")}
    assert max(r[3] for r in rows) < cs.ORACLE_ERR
    assert rows[-1][:2] == ("compat example", "SPG-QP") and rows[-1][4] < 1e-10


def test_reference_api_full_width_check_wiring():
    """(p) 2 on the CPU: check_result on the iterative mode's result gives
    the JAX package's report on the JAX package's result."""
    from ccqppy_tpu.utils.diagnostics import check_result as jax_check_result

    cs = _chip_smoke()
    A, b, jproj, jcfg, At, bt, proj, cfg = _setup(48, cs)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    diag = jnp.diagonal(Aj, axis1=-2, axis2=-1)
    rj = jax_fused_compact("pcg", Aj, bj, cs.PHASE1, x0=jnp.clip(-bj / diag, -1.0, 1.0),
                           proj=jproj, config=jcfg, bucket=cs.BUCKET, host_fallback=False)
    rt = cs.run_iterative(At, bt, At.diagonal(dim1=-2, dim2=-1), proj, cfg)
    rep = cs.check_full_width(rt, At, bt, proj)
    rep_j = jax_check_result(rj, proj=jproj, A=Aj, b=bj)
    assert list(rep) == list(rep_j)
    assert {k: v for k, v in rep.items() if k != "residual_rel_err"} == \
        {k: v for k, v in rep_j.items() if k != "residual_rel_err"}
    np.testing.assert_allclose(rep["residual_rel_err"], rep_j["residual_rel_err"], atol=1e-6)
    # An x outside the box fails the phase.
    with pytest.raises(RuntimeError, match="full width"):
        cs.check_full_width(dataclasses.replace(rt, x=rt.x + 10.0), At, bt, proj)


def test_reference_api_harness_wiring(monkeypatch):
    """(p) 3 on the CPU at 4 trials, n = 24 and a 500 budget (bbpgd_f's
    frozen f32 lanes would spend 5000): the solvers and families of the
    phase, pcg converged on every lane of every family, the results
    round-trip through to_json."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "HARNESS_T", 4)
    monkeypatch.setattr(cs, "HARNESS_BUDGET", 500)
    monkeypatch.setattr(cs, "HARNESS_N", 24)
    monkeypatch.setattr(cs, "HARNESS_N_DJ", 24)
    single, dj = cs.run_harness("cpu")
    assert single.solver_names == ["pcg", "bbpgd_f"] and single.sizes == [24]
    assert single.family_names == ["identity", "lower", "upper", "ball", "box"]
    assert dj.solver_names == ["mprgp_bb"] and dj.family_names == ["dj_cone"]
    assert single.converged.shape == (2, 5, 1, 4) and bool(single.converged[0].all())
    assert np.isfinite(single.residual).all() and np.isfinite(dj.residual).all()
