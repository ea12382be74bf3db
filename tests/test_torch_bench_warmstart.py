"""The warm-start study (``ccqppy_tpu_torch.benchmarks.benchmark_warmstart_sequence``)
against the step of the JAX package's ``benchmarks/benchmark_warmstart_sequence.py``,
in f64 on the CPU.

The JAX script draws its walk inside a ``lax.scan``; here both packages
take one numpy walk.  Per step the JAX side runs the script's step
(``b += drift``, the vmapped PCG from the previous x or from 0), the port
``run_sequence``; the per-step statistics and the last x match.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_bench_cases import (assert_card_stamp, assert_has_keys, assert_needs_a_card,
                                family, jax_keys)
from ccqppy_tpu.models import SOLVERS as JAX_SOLVERS
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu_torch.benchmarks import benchmark_warmstart_sequence as ws
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box

torch.set_num_threads(1)

B, N, STEPS = 6, 32, 4


def jax_sequence(A, b0, drifts, warm):
    """The JAX script's scan body, one step at a time: (last x, per-step
    (sum of matvecs, all converged, max residual, max matvecs))."""
    jproj = JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=ws.TOL, max_matvecs=ws.BUDGET)
    solve = JAX_SOLVERS["pcg"][0]
    run = jax.jit(jax.vmap(lambda A_, b_, x0_: solve(A_, b_, x0=x0_, proj=jproj, config=jcfg)))
    b, x, stats = jnp.asarray(b0), jnp.zeros_like(jnp.asarray(b0)), []
    for d in drifts:
        b = b + d
        r = run(jnp.asarray(A), b, x if warm else jnp.zeros_like(b))
        stats.append([float(jnp.sum(r.matvecs)), float(jnp.all(r.converged)),
                      float(jnp.max(r.residual)), float(jnp.max(r.matvecs))])
        x = r.x
    return np.asarray(x), np.asarray(stats)


def test_sequence_matches_jax_cold_and_warm():
    A, b0 = family(3, B, N)
    scale = ws.DRIFT * np.abs(b0).mean()
    drifts = scale * np.random.default_rng(4).standard_normal((STEPS, B, N))
    proj = box(-torch.ones(N), torch.ones(N), dtype=torch.float64)
    cfg = PCGConfig(tol=ws.TOL, max_matvecs=ws.BUDGET)
    totals = {}
    for warm in (False, True):
        xj, sj = jax_sequence(A, b0, drifts, warm)
        x, b_T, st = ws.run_sequence(torch.from_numpy(A), torch.from_numpy(b0),
                                     [torch.from_numpy(d) for d in drifts], proj, cfg, warm)
        np.testing.assert_allclose(b_T.numpy(), b0 + drifts.sum(0), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(st[:, [0, 1, 3]].numpy(), sj[:, [0, 1, 3]])
        np.testing.assert_allclose(st[:, 2].numpy(), sj[:, 2], rtol=0, atol=1e-12)
        np.testing.assert_allclose(x.numpy(), xj, rtol=0, atol=1e-10)
        assert sj[:, 1].all()
        totals[warm] = sj[:, 0].sum()
    assert totals[True] < totals[False]


def test_walk_is_drawn_again_from_its_rep():
    b = torch.zeros((2, 5), dtype=torch.float64)
    one, again, other = ([*ws.walk(b, 0.5, 3, rep)] for rep in (0, 0, 1))
    assert len(one) == 3 and all(torch.equal(p, q) for p, q in zip(one, again))
    assert not torch.equal(one[0], other[0]) and not torch.equal(one[0], one[1])


def test_main_writes_the_jax_keys_with_a_card_stamp(tmp_path):
    p = ws.main(B=4, n=24, steps=3, device="cpu", dtype=torch.float64, out=tmp_path)
    assert_has_keys(p, jax_keys("warmstart_sequence.json"), "warmstart_sequence")
    assert_card_stamp(p)
    for v in ("cold", "warm"):
        assert p[v]["all_converged"] and p[v]["true_residual_last_step"] <= ws.TOL
    assert p["matvec_ratio_cold_over_warm"] > 1
    assert (tmp_path / "warmstart_sequence.json").exists()


def test_cli_needs_a_card():
    assert_needs_a_card(ws.cli)
