"""The streamed ensemble study (``ccqppy_tpu_torch.benchmarks.benchmark_ensemble_16k``)
in f64 on the CPU: each streamed chunk is bitwise ``solve_batched`` on that
chunk, and on numpy chunks fed to both packages the stream matches the
JAX script's scan body (PCG from the Jacobi start, vmapped over a chunk)
per lane.
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
from ccqppy_tpu_torch.benchmarks import benchmark_ensemble_16k as ens
from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import solve_batched

torch.set_num_threads(1)

CHUNKS, CHUNK, N, SEED = 3, 4, 24, 5
F64 = torch.float64


def _set():
    return (box(-torch.ones(N), torch.ones(N), dtype=F64),
            PCGConfig(tol=ens.TOL, max_matvecs=ens.BUDGET))


def test_streamed_chunks_are_solve_batched_bitwise():
    proj, cfg = _set()
    conv, mv, xsum = ens.stream(SEED, CHUNKS, CHUNK, N, proj, cfg, F64, torch.device("cpu"))
    assert conv.shape == mv.shape == xsum.shape == (CHUNKS, CHUNK)
    for k in range(CHUNKS):
        A, b = ens.draw_chunk(SEED, k, CHUNK, N, F64, "cpu")
        r = solve_batched("pcg", A, b, x0=torch.clamp(-b / A.diagonal(dim1=-2, dim2=-1), -1, 1),
                          proj=proj, config=cfg)
        assert torch.equal(conv[k], r.converged) and torch.equal(mv[k], r.matvecs)
        assert torch.equal(xsum[k], r.x.abs().sum(dim=-1))
    A0, _ = ens.draw_chunk(SEED, 0, CHUNK, N, F64, "cpu")
    assert torch.equal(A0, ens.draw_chunk(SEED, 0, CHUNK, N, F64, "cpu")[0])
    assert not torch.equal(A0, ens.draw_chunk(SEED, 1, CHUNK, N, F64, "cpu")[0])


def test_stream_matches_jax_on_numpy_chunks(monkeypatch):
    chunks = [family(20 + k, CHUNK, N, scale=2.0) for k in range(CHUNKS)]

    def numpy_chunk(gen, batch, n, dtype, diag_boost=0.0, chunk=None):
        k = gen.initial_seed() - common.seed_of(SEED, 0)
        A, b = chunks[k]
        return torch.from_numpy(A), torch.from_numpy(b), None

    monkeypatch.setattr(ens, "random_qp_batch", numpy_chunk)
    proj, cfg = _set()
    conv, mv, xsum = ens.stream(SEED, CHUNKS, CHUNK, N, proj, cfg, F64, torch.device("cpu"))
    jproj = JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=ens.TOL, max_matvecs=ens.BUDGET)
    solve = JAX_SOLVERS["pcg"][0]
    for k, (A, b) in enumerate(chunks):
        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        x0 = jnp.clip(-bj / jnp.diagonal(Aj, axis1=-2, axis2=-1), -1.0, 1.0)
        rj = jax.vmap(lambda A_, b_, x0_: solve(A_, b_, x0=x0_, proj=jproj, config=jcfg))(
            Aj, bj, x0)
        assert bool(np.asarray(rj.converged).all())
        np.testing.assert_array_equal(conv[k].numpy(), np.asarray(rj.converged))
        np.testing.assert_array_equal(mv[k].numpy(), np.asarray(rj.matvecs))
        np.testing.assert_allclose(xsum[k].numpy(), np.abs(np.asarray(rj.x)).sum(-1),
                                   rtol=0, atol=N * 1e-10)


def test_main_writes_the_jax_keys_with_a_card_stamp(tmp_path):
    p = ens.main(total=12, chunk=4, n=20, device="cpu", dtype=F64, out=tmp_path)
    assert_has_keys(p, jax_keys("ensemble_16k.json"), "ensemble_16k")
    assert p["total_problems"] == 12 and p["convergence_rate"] == 1.0
    assert p["fenced_true_residual_max"] <= ens.TOL
    assert_card_stamp(p)


def test_cli_needs_a_card():
    assert_needs_a_card(ens.cli)
