"""The random-ensemble harness (``utils.benchmark``) and plotting
(``utils.plotting``) against the JAX package's, in f64 on the CPU.

The two harnesses draw their ensembles from different generators, so both
get the same numpy-drawn ensemble through their ``random_qp_batch``
(patched here, in the tests only), and SPG's cells draw the JAX uniforms
of the JAX keys through ``spg.solve(draw=...)``.  Every cell's residual,
``converged`` and matvec count then match per lane.
"""
import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.utils import benchmark as jbench
from ccqppy_tpu.utils import plotting as jplotting
from ccqppy_tpu_torch.models import spg
from ccqppy_tpu_torch.parallel import batch
from ccqppy_tpu_torch.utils import benchmark, plotting, rng
from ccqppy_tpu_torch.utils.convert import proj_from_jax
from test_torch_spg import draw_table

torch.set_num_threads(1)

T = 4
SIZES = [6, 12]
SOLVERS = ["pcg", "bbpgd", "spg"]
SEED = 3
# On the cone both packages' f64 trajectories part at the rounding of XLA's
# fused multiply-adds (ROADMAP queue 3): counts stay equal up to tol 1e-6,
# and the residuals near tol agree to 2% of it.  The box agrees to 1e-12.
TOL = 1e-6
RESIDUAL_ATOL = {"box": 1e-12, "dj_cone": 2e-2 * TOL}


def _ensembles():
    """The random_qp family (A = G G^T + n I, b = -A x, x ~ U(-1, 1)) drawn
    with numpy, one batch per size."""
    out = {}
    for n in SIZES:
        r = np.random.default_rng(100 + n)
        G = r.standard_normal((T, n, n))
        A = G @ G.transpose(0, 2, 1) + n * np.eye(n)
        out[n] = (A, -np.einsum("bij,bj->bi", A, r.uniform(-1, 1, (T, n))))
    return out


def _families(module, dtype, **device):
    return {"box": module.default_families(dtype, **device)["box"],
            "dj_cone": module.disjoint_families(3, dtype, **device)["dj_cone"]}


@pytest.fixture(scope="module")
def runs():
    """Both harnesses over SOLVERS x (box, dj_cone) x SIZES on the same
    ensembles; the port's with a ``check`` hook recording every timed rep."""
    E = _ensembles()
    pk = rng.split_keys(SEED + 1, T)
    jk = jax.random.split(jax.random.PRNGKey(SEED + 1), T)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbench, "random_qp_batch",
                   lambda key, T, n, dtype, diag_boost=0.0: (jnp.asarray(E[n][0]),
                                                             jnp.asarray(E[n][1]), None))
        mp.setattr(benchmark, "random_qp_batch",
                   lambda gen, T, n, dtype, diag_boost=0.0: (torch.tensor(E[n][0]),
                                                             torch.tensor(E[n][1]), None))
        mp.setitem(batch.SOLVERS, "spg",
                   (partial(spg.solve, draw=draw_table([(pk, jk)], 3000)), spg.SPGConfig))
        jb = jbench.BenchmarkRandomCCQP(T, SOLVERS, _families(jbench, jnp.float64), SIZES,
                                        tol=TOL, max_matvecs=2000, dtype=jnp.float64,
                                        seed=SEED)
        tb = benchmark.BenchmarkRandomCCQP(T, SOLVERS, _families(benchmark, torch.float64,
                                                                 device="cpu"),
                                           SIZES, tol=TOL, max_matvecs=2000,
                                           dtype=torch.float64, seed=SEED, device="cpu")
        rj = jb.run(verbose=False)
        rt = tb.run(verbose=False, check=lambda *a: seen.append(a))
    return jb, tb, rj, rt, seen


@pytest.mark.parametrize("solver", SOLVERS)
def test_cells_match_jax(runs, solver):
    _, _, rj, rt, _ = runs
    i = SOLVERS.index(solver)
    assert bool(rj.converged[i].all())
    np.testing.assert_array_equal(rt.converged[i], rj.converged[i])
    np.testing.assert_array_equal(rt.matvecs[i], rj.matvecs[i])
    for j, fam in enumerate(rt.family_names):
        np.testing.assert_allclose(rt.residual[i, j], rj.residual[i, j], rtol=0,
                                   atol=RESIDUAL_ATOL[fam], err_msg=fam)
    assert bool((rt.residual[i] <= TOL).all())


def test_result_shape_json_summary(runs):
    _, tb, rj, rt, seen = runs
    shape = (len(SOLVERS), 2, len(SIZES), T)
    for field in ("residual", "converged", "solve_time", "matvecs"):
        assert getattr(rt, field).shape == shape
    assert bool((rt.solve_time > 0).all())
    assert tb.result is rt and rt.family_names == ["box", "dj_cone"]
    tj, tt = json.loads(rj.to_json()), json.loads(rt.to_json())
    assert list(tt) == list(tj)
    for k in ("solvers", "families", "sizes", "num_trials", "converged", "matvecs"):
        assert tt[k] == tj[k], k
    lines = rt.summary().splitlines()
    assert len(lines) == len(rj.summary().splitlines()) == np.prod(shape[:3])
    assert lines[0].startswith("pcg        box          n=6 ")
    # The check hook saw both timed reps of every cell.
    assert len(seen) == 2 * np.prod(shape[:3])
    assert {(s, f, n) for s, f, n, _ in seen} == {
        (s, f, n) for s in SOLVERS for f in ("box", "dj_cone") for n in SIZES}


def test_to_json_writes_file(runs, tmp_path):
    rt = runs[3]
    path = tmp_path / "r.json"
    text = rt.to_json(path)
    assert path.read_text() == text
    back = json.loads(text)
    np.testing.assert_array_equal(np.asarray(back["matvecs"]), rt.matvecs)
    np.testing.assert_array_equal(np.asarray(back["residual"]), rt.residual)


def test_plots_render(runs, tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("scipy")
    tb, rt = runs[1], runs[3]
    fig = rt.plot("residual", do_log_y=True)
    assert len(fig.axes) == 2
    figs = tb.process_results(save_prefix=str(tmp_path / "bench"))
    assert len(figs) == 3
    for metric in ("solve_time", "matvecs", "residual"):
        assert (tmp_path / f"bench_{metric}.png").stat().st_size > 0


def test_process_results_needs_a_run():
    tb = benchmark.BenchmarkRandomCCQP(2, ["pcg"], _families(benchmark, torch.float64,
                                                             device="cpu"), [6],
                                       device="cpu")
    with pytest.raises(RuntimeError, match="run"):
        tb.process_results()


def test_families_match_jax():
    """Every family builds the JAX family's set, with the same parameters,
    in the requested dtype on the requested device."""
    for jfams, tfams, n in ((jbench.default_families(jnp.float64),
                             benchmark.default_families(torch.float64, "cpu"), 7),
                            (jbench.disjoint_families(3, jnp.float64),
                             benchmark.disjoint_families(3, torch.float64, "cpu"), 9)):
        assert list(tfams) == list(jfams)
        for name in jfams:
            jp, tp = jfams[name](n, jnp.float64), tfams[name](n, torch.float64)
            ref = proj_from_jax(jp)
            assert type(tp) is type(ref), name
            ref_bufs = dict(ref.named_buffers())
            for k, v in tp.named_buffers():
                assert v.dtype == torch.float64 and v.device.type == "cpu"
                np.testing.assert_array_equal(v.numpy(), ref_bufs[k].numpy(), err_msg=name)
    with pytest.raises(ValueError, match="multiple"):
        benchmark.disjoint_families(3, torch.float64, "cpu")["dj_box"](8, torch.float64)


def test_harness_on_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    tb = benchmark.BenchmarkRandomCCQP(2, ["pcg"], benchmark.default_families(), [6])
    with pytest.raises((RuntimeError, AssertionError)):
        tb.run(verbose=False)


def _sets():
    """(JAX set, dim) pairs for the projection-sample tests."""
    from ccqppy_tpu.ops import projections as JP
    return [(JP.box(-jnp.ones(3), jnp.ones(3), jnp.float64), 3),
            (JP.ball(1.0, dtype=jnp.float64), 3),
            (JP.lorentz_cone(1.0, dtype=jnp.float64), 3),
            (JP.blockwise(JP.lorentz_cone(1.0, dtype=jnp.float64), 3), 6),
            (JP.identity(), 2)]


@pytest.mark.parametrize("k", range(5))
def test_projection_samples_match_jax(k):
    jp, dim = _sets()[k]
    xs, projected = plotting.project_samples(proj_from_jax(jp), dim, 50, -2.0, 2.0, seed=4)
    ref_xs = np.random.default_rng(4).uniform(-2.0, 2.0, (50, dim))
    np.testing.assert_array_equal(xs, ref_xs)
    np.testing.assert_allclose(projected, np.asarray(jax.vmap(jp.project)(jnp.asarray(xs))),
                               rtol=0, atol=1e-12)


def test_plot_projection_samples_plots_jax_points():
    """The scatter's points are those of the JAX package's plot."""
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    for jp, dim in _sets()[:3]:
        ax_t = plotting.plot_projection_samples(proj_from_jax(jp), dim, 40, -2, 2, seed=1)
        ax_j = jplotting.plot_projection_samples(jp, dim, 40, -2, 2, seed=1)
        pts_t = np.asarray(ax_t.collections[0]._offsets3d)
        pts_j = np.asarray(ax_j.collections[0]._offsets3d)
        np.testing.assert_allclose(pts_t, pts_j, rtol=0, atol=1e-12)
        plt.close("all")


@pytest.mark.cuda
def test_tiny_run_on_cuda():
    """One small run on the card, f32, through the GEMV kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccqppy_tpu_torch.ops import gemv
    torch.backends.cuda.matmul.allow_tf32 = False
    before = gemv.LAUNCHES - gemv.LAUNCHES_F64 - gemv.LAUNCHES_BF16
    tb = benchmark.BenchmarkRandomCCQP(8, ["pcg", "bbpgd_f"], benchmark.default_families(),
                                       [16, 64], tol=1e-4, diag_boost=1.0)
    r = tb.run(verbose=False)
    assert gemv.LAUNCHES - gemv.LAUNCHES_F64 - gemv.LAUNCHES_BF16 > before
    assert bool(r.converged[0].all()) and np.isfinite(r.residual).all()
    assert (r.solve_time > 0).all()
