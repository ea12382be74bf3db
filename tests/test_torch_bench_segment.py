"""The mixed-segment study (``ccqppy_tpu_torch.benchmarks.benchmark_mixed_segment``)
against the JAX package's ``benchmarks/benchmark_mixed_segment.py``, in f64
on the CPU.

The set is built from numpy's ``default_rng(7)`` draws in the JAX script's
order by both packages (the JAX side here repeats the script's loop), so
the two sets are equal.  On one numpy ensemble the study's two solvers
(``apgd_sc`` on ``SpectralDense`` from the projected Jacobi start, fused
MPRGP-BB) match per lane in counts and ``converged``, and ``apgd_sc`` in x
to 1e-10.  MPRGP-BB's x agrees to 1e-8 on the cone blocks, where the two
packages round XLA's fused multiply-adds apart (ROADMAP queue 3; 1.4e-10
seen here).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_bench_cases import (assert_card_stamp, assert_has_keys, assert_lanes_match,
                                assert_needs_a_card, family, jax_keys)
from ccqppy_tpu.models import APGDSCConfig as JaxAPGDSCConfig
from ccqppy_tpu.models import MPRGPBBConfig as JaxMPRGPBBConfig
from ccqppy_tpu.ops import linop as JL
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel import solve_batched as jax_solve_batched
from ccqppy_tpu_torch.benchmarks import benchmark_mixed_segment as ms
from ccqppy_tpu_torch.models.apgd import APGDSCConfig
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig
from ccqppy_tpu_torch.ops.linop import SpectralDense, estimate_spectral_bounds

torch.set_num_threads(1)

B, N = 6, 60
XTOL = 1e-10
XTOL_MPRGP = 1e-8   # cone blocks: XLA's fused multiply-adds (ROADMAP queue 3)


def jax_segment_set(n):
    """The JAX script's loop (``benchmark_mixed_segment.py:65-78``) in f64."""
    rng = np.random.default_rng(7)
    blocks = []
    for i in range(n // 3):
        if i % 2 == 0:
            blocks.append((JP.lorentz_cone(float(rng.uniform(0.5, 2.0)), jnp.float64), 3))
        else:
            hw = rng.uniform(0.5, 1.5, 3).astype(np.float32)
            blocks.append((JP.box(-hw, hw, jnp.float64), 3))
    return JP.segment_product(*blocks)


def test_segment_set_is_the_jax_scripts():
    jproj = jax_segment_set(N)
    proj = ms.segment_set(N, torch.float64)
    assert proj.counts == (10, 10) and len(ms.segment_blocks(N)) == 20
    x = 2 * np.random.default_rng(5).standard_normal((B, N))
    np.testing.assert_allclose(proj.project(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(jproj.project)(jnp.asarray(x))),
                               rtol=0, atol=1e-14)


def _ensemble():
    A, b = family(6, B, N, scale=2.0)
    jproj = jax_segment_set(N)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    jx0 = jax.vmap(jproj.project)(-bj / jnp.diagonal(Aj, axis1=-2, axis2=-1))
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    return Aj, bj, jproj, jx0, At, bt, ms.segment_set(N, torch.float64)


def test_apgd_sc_matches_jax():
    Aj, bj, jproj, jx0, At, bt, proj = _ensemble()
    Lj, muj = JL.estimate_spectral_bounds(Aj, iters=ms.SPECTRAL_ITERS)
    rj = jax_solve_batched("apgd_sc", JL.SpectralDense(Aj, Lj, muj), bj, x0=jx0, proj=jproj,
                           config=JaxAPGDSCConfig(tol=ms.TOL, max_matvecs=ms.BUDGET))
    L, mu = estimate_spectral_bounds(At, iters=ms.SPECTRAL_ITERS)
    rt = ms.run_apgd_sc(SpectralDense(At, L, mu), bt, At.diagonal(dim1=-2, dim2=-1), proj,
                        APGDSCConfig(tol=ms.TOL, max_matvecs=ms.BUDGET))
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, XTOL)


def test_mprgp_bb_matches_jax():
    Aj, bj, jproj, jx0, At, bt, proj = _ensemble()
    rj = jax_solve_batched("mprgp_bb", Aj, bj, x0=jx0, proj=jproj,
                           config=JaxMPRGPBBConfig(tol=ms.TOL, max_matvecs=ms.BUDGET, fused=True))
    rt = ms.run_mprgp(At, bt, At.diagonal(dim1=-2, dim2=-1), proj,
                      MPRGPBBConfig(tol=ms.TOL, max_matvecs=ms.BUDGET, fused=True))
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt, XTOL_MPRGP)


def test_main_writes_the_jax_keys_with_a_card_stamp(tmp_path):
    p = ms.main(B=4, n=30, device="cpu", dtype=torch.float64, out=tmp_path)
    want = jax_keys("mixed_segment_ensemble.json")
    assert_has_keys(p, want, "mixed_segment_ensemble")
    assert [r["solver"] for r in p["rows"]] == [r["solver"] for r in want["rows"]]
    for got in p["rows"]:
        assert got["converged"] == 1.0 and got["true_residual_max"] <= ms.TOL * 1.05
    assert p["rows"][0]["segment_build_s"] > 0
    assert_card_stamp(p)


def test_cli_needs_a_card():
    assert_needs_a_card(ms.cli)
