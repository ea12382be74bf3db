"""Port parity: ccqppy_tpu_torch's BlockSparseOperator against ccqppy_tpu's.

The ELL operator (``ops/linop.py``) and its scipy builder, the huge-QP
problem of ``benchmarks/benchmark_huge_qp.py`` (``block_tridiag_qp`` in
``utils/random_qp.py``), and PCG on it, on the CPU in f64, per lane.  The
matvec has no kernel on either side (XLA's gather and einsum there, plain
PyTorch here): the two differ only in the order of the f64 sums.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.models import pcg as jax_pcg
from ccqppy_tpu.ops import linop as JL
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import pcg
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import BlockSparseOperator
from ccqppy_tpu_torch.utils.convert import config_from_jax, operator_from_jax, proj_from_jax
from ccqppy_tpu_torch.utils.random_qp import block_tridiag_qp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N_HUGE = 400     # the huge-QP family at n = 400 (100 block-rows)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def huge_qp_benchmark():
    return _load("benchmark_huge_qp", ROOT / "benchmarks" / "benchmark_huge_qp.py")


def chip_smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


def random_ell(seed, B=3, nbr=7, kmax=3, bs=4):
    """Random ELL arrays, batched, f64 blocks and int64 columns (repeats
    allowed: a block-row may point at a column twice)."""
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((B, nbr, kmax, bs, bs))
    cols = rng.integers(0, nbr, (B, nbr, kmax))
    cols[:, :, 0] = np.arange(nbr)           # the diagonal block in slot 0
    return blocks, cols


def jax_stacked(blocks, cols):
    n = blocks.shape[1] * blocks.shape[3]
    return JL.BlockSparseOperator(jnp.asarray(blocks), jnp.asarray(cols, jnp.int32), n)


def test_operator_matches_jax_per_lane():
    """matvec, diagonal and inf_norm, lane by lane, against the JAX operator
    under vmap; take(idx) gathers lanes.  f64 sums in another order: 1e-14."""
    blocks, cols = random_ell(0)
    op = BlockSparseOperator(torch.from_numpy(blocks), torch.from_numpy(cols))
    jop = jax_stacked(blocks, cols)
    x = np.random.default_rng(1).standard_normal((3, op.n))
    y = op.matvec(torch.from_numpy(x))
    yj = jax.vmap(lambda o, v: o.matvec(v))(jop, jnp.asarray(x))
    assert y.dtype == torch.float64 and y.shape == (3, 28)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(op.diagonal().numpy(),
                               np.asarray(jax.vmap(lambda o: o.diagonal())(jop)), rtol=0, atol=0)
    np.testing.assert_allclose(op.inf_norm().numpy(),
                               np.asarray(jax.vmap(lambda o: o.inf_norm())(jop)), rtol=1e-15)
    idx = torch.tensor([2, 0])
    sub = op.take(idx)
    assert sub.n == op.n and torch.equal(sub.matvec(torch.from_numpy(x)[idx]), y[idx])
    # The dense matrix the ELL arrays stand for, lane by lane.
    for lane in range(3):
        dense = np.zeros((28, 28))
        for r in range(7):
            for k in range(3):
                c = cols[lane, r, k]
                dense[4 * r:4 * r + 4, 4 * c:4 * c + 4] += blocks[lane, r, k]
        np.testing.assert_allclose(y[lane].numpy(), dense @ x[lane], rtol=1e-13, atol=1e-13)


def test_matvec_keeps_x_precision():
    """f32 blocks with an f64 x give an f64 product of the f32 values."""
    blocks, cols = random_ell(2, B=1)
    op = BlockSparseOperator(torch.from_numpy(blocks).float(), torch.from_numpy(cols))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, op.n)))
    y = op.matvec(x)
    ref = BlockSparseOperator(op.blocks.double(), op.cols).matvec(x)
    assert y.dtype == torch.float64 and torch.equal(y, ref)
    assert op.matvec(x.float()).dtype == torch.float32


def ragged_bsr(seed, nbr=9, bs=3):
    """A BSR matrix with ragged block-rows: row 4 empty, row 6 full, the
    others 1-4 blocks in scipy's stored order."""
    rng = np.random.default_rng(seed)
    indptr, indices = [0], []
    for r in range(nbr):
        k = 0 if r == 4 else nbr if r == 6 else int(rng.integers(1, 5))
        indices.extend(sorted(rng.choice(nbr, k, replace=False)))
        indptr.append(len(indices))
    data = rng.standard_normal((len(indices), bs, bs))
    return sp.bsr_matrix((data, np.array(indices), np.array(indptr)), shape=(nbr * bs, nbr * bs))


@pytest.mark.parametrize("seed", [0, 1])
def test_from_scipy_bsr_is_jax_builder(seed):
    """The vectorised builder gives JAX's blocks and cols (zero blocks at
    column 0 in the padding), stacked as one lane, and the matrix's own
    product; a CSR input is converted as JAX converts it."""
    mat = ragged_bsr(seed)
    jop = JL.BlockSparseOperator.from_scipy_bsr(mat, dtype=jnp.float64)
    op = BlockSparseOperator.from_scipy_bsr(mat, dtype=torch.float64)
    assert op.blocks.shape == (1, *jop.blocks.shape) and op.n == jop.n
    np.testing.assert_array_equal(op.blocks[0].numpy(), np.asarray(jop.blocks))
    np.testing.assert_array_equal(op.cols[0].numpy(), np.asarray(jop.cols))
    assert op.cols.dtype == torch.int64
    x = np.random.default_rng(seed + 10).standard_normal(op.n)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)[None])[0].numpy(), mat @ x,
                               rtol=1e-13, atol=1e-13)
    csr = sp.csr_matrix(np.kron(np.eye(3), np.ones((2, 2))))
    jc = JL.BlockSparseOperator.from_scipy_bsr(csr, dtype=jnp.float64)
    tc = BlockSparseOperator.from_scipy_bsr(csr, dtype=torch.float64)
    np.testing.assert_array_equal(tc.blocks[0].numpy(), np.asarray(jc.blocks))
    np.testing.assert_array_equal(tc.cols[0].numpy(), np.asarray(jc.cols))


def test_from_scipy_bsr_rejects_rectangular_blocks():
    mat = sp.bsr_matrix(np.ones((4, 6)), blocksize=(2, 3))
    with pytest.raises(ValueError, match="square"):
        BlockSparseOperator.from_scipy_bsr(mat)


@pytest.mark.parametrize("blocks,cols,error", [
    (torch.zeros((1, 2, 3, 4, 4)), torch.zeros((1, 2, 3), dtype=torch.int32), TypeError),
    (torch.zeros((1, 2, 3, 4, 4)), torch.zeros((1, 2, 2), dtype=torch.int64), TypeError),
    (torch.zeros((1, 2, 3, 4, 4), dtype=torch.bfloat16), torch.zeros((1, 2, 3), dtype=torch.int64),
     TypeError),
    (torch.zeros((2, 3, 4, 4)), torch.zeros((2, 3), dtype=torch.int64), ValueError),
    (torch.zeros((1, 2, 3, 4, 3)), torch.zeros((1, 2, 3), dtype=torch.int64), ValueError),
], ids=["int32-cols", "cols-shape", "bf16-blocks", "unbatched", "non-square"])
def test_constructor_checks(blocks, cols, error):
    with pytest.raises(error):
        BlockSparseOperator(blocks, cols)


def test_from_dense_blocks_takes_one_problem_or_a_stack():
    blocks, cols = random_ell(4, B=2)
    one = BlockSparseOperator.from_dense_blocks(torch.from_numpy(blocks[0]),
                                                torch.from_numpy(cols[0]).int())
    two = BlockSparseOperator.from_dense_blocks(torch.from_numpy(blocks), torch.from_numpy(cols))
    assert one.blocks.shape[0] == 1 and two.blocks.shape[0] == 2
    assert one.cols.dtype == torch.int64 and torch.equal(one.cols[0], two.cols[0])


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
def test_operator_from_jax(stacked):
    blocks, cols = random_ell(5, B=2)
    if stacked:
        jop = jax_stacked(blocks, cols)
    else:
        jop = JL.BlockSparseOperator.from_dense_blocks(jnp.asarray(blocks[0]), jnp.asarray(cols[0]))
    op = operator_from_jax(jop, "cpu", torch.float64)
    assert isinstance(op, BlockSparseOperator) and op.n == jop.n
    np.testing.assert_array_equal(op.blocks.numpy(), blocks if stacked else blocks[:1])
    np.testing.assert_array_equal(op.cols.numpy(), cols if stacked else cols[:1])


# ------------------------------------------------------------ the huge QP

@pytest.mark.parametrize("seed", [0, 3])
def test_block_tridiag_is_the_benchmark_problem(seed):
    """The port's copy of ``build_block_tridiag`` draws the same numbers in
    the same order: blocks, cols and x_exact bitwise the JAX script's, b
    (computed by each package in f32) within f32 rounding."""
    bench = huge_qp_benchmark()
    jop, jb, jx = bench.build_block_tridiag(N_HUGE, seed)
    op, b, x = block_tridiag_qp(N_HUGE, seed)
    assert (op.blocks.dtype, b.dtype, x.dtype) == (torch.float32,) * 3
    np.testing.assert_array_equal(op.blocks[0].numpy(), np.asarray(jop.blocks))
    np.testing.assert_array_equal(op.cols[0].numpy(), np.asarray(jop.cols))
    np.testing.assert_array_equal(x[0].numpy(), np.asarray(jx))
    np.testing.assert_allclose(b[0].numpy(), np.asarray(jb), rtol=0, atol=2e-6)
    # SPD: the stacked dense matrix is symmetric with a positive spectrum.
    dense = np.zeros((N_HUGE, N_HUGE))
    bl, cl = op.blocks[0].double().numpy(), op.cols[0].numpy()
    for r in range(N_HUGE // 4):
        for k in range(3):
            dense[4 * r:4 * r + 4, 4 * cl[r, k]:4 * cl[r, k] + 4] += bl[r, k]
    np.testing.assert_array_equal(dense, dense.T)
    assert np.linalg.eigvalsh(dense)[0] > 0
    np.testing.assert_array_equal(op.diagonal()[0].numpy(), np.diag(dense).astype(np.float32))


def test_huge_qp_pcg_matches_benchmark_wiring():
    """Mode (k) of chip_smoke.py as the JAX script runs it (its problem, box
    [-1, 1], PCG at tol 1e-9 with a budget of 10,000, from the default
    start), in f64 at n = 400: equal ``converged`` and matvec counts, x
    within 1e-10, and the f64 audit agrees with the solver's residual."""
    bench = huge_qp_benchmark()
    cs = chip_smoke()
    jop, jb, _ = bench.build_block_tridiag(N_HUGE, 0, dtype=jnp.float64)
    jproj = JP.box(-jnp.ones(N_HUGE), jnp.ones(N_HUGE), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=bench.TOL, max_matvecs=bench.BUDGET)
    assert (cs.TOL_HUGE, cs.BUDGET_HUGE) == (bench.TOL, bench.BUDGET)
    rj = jax_pcg.solve(jop, jb, proj=jproj, config=jcfg)
    op, b, x_exact = block_tridiag_qp(N_HUGE, 0, dtype=torch.float64)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(jb), rtol=0, atol=1e-14)
    proj = proj_from_jax(jproj)
    rt = cs.run_huge(op, b, proj, config_from_jax(jcfg))
    assert bool(rj.converged) and bool(rt.converged.all())
    assert int(rt.matvecs[0]) == int(rj.matvecs) and int(rt.iterations[0]) == int(rj.iterations)
    np.testing.assert_allclose(rt.x[0].numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)
    audit = cs.audit_blocksparse(op, b, rt.x)
    np.testing.assert_allclose(audit.numpy(), rt.residual.numpy(), rtol=1e-9, atol=1e-16)


def test_huge_qp_pcg_matches_jax_per_lane():
    """Three draws of the huge-QP family stacked as lanes: per lane equal
    ``converged`` and matvec counts, x within 1e-10."""
    bench = huge_qp_benchmark()
    draws = [bench.build_block_tridiag(N_HUGE, s, dtype=jnp.float64) for s in (1, 2, 3)]
    jop = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[d[0] for d in draws])
    jb = jnp.stack([d[1] for d in draws])
    jproj = JP.box(-jnp.ones(N_HUGE), jnp.ones(N_HUGE), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=1e-10, max_matvecs=2000)
    rj = solve_batched("pcg", jop, jb, proj=jproj, config=jcfg)
    ops = [block_tridiag_qp(N_HUGE, s, dtype=torch.float64) for s in (1, 2, 3)]
    op = BlockSparseOperator(torch.cat([o.blocks for o, _, _ in ops]),
                             torch.cat([o.cols for o, _, _ in ops]))
    rt = pcg.solve(op, torch.cat([b for _, b, _ in ops]), proj=proj_from_jax(jproj),
                   config=config_from_jax(jcfg))
    assert bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)


def test_huge_qp_compaction_matches_jax():
    """Straggler compaction gathers a block-sparse operator by ``take``:
    the fused two-phase solve (phase 1 at 5 matvecs, a bucket of 4) on four
    stacked draws at n = 40, against the JAX package's on the stacked
    pytree: per lane equal ``converged`` and matvec counts, x within 1e-10."""
    from ccqppy_tpu.parallel import solve_batched_fused_compact as jax_fused_compact
    from ccqppy_tpu_torch.parallel import solve_batched_fused_compact

    bench = huge_qp_benchmark()
    seeds = (4, 5, 6, 7)
    draws = [bench.build_block_tridiag(40, s, dtype=jnp.float64) for s in seeds]
    jop = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[d[0] for d in draws])
    jb = jnp.stack([d[1] for d in draws])
    jproj = JP.box(-jnp.ones(40), jnp.ones(40), dtype=jnp.float64)
    jcfg = JaxPCGConfig(tol=1e-10, max_matvecs=500)
    rj = jax_fused_compact("pcg", jop, jb, 5, proj=jproj, config=jcfg, bucket=4,
                           host_fallback=False)
    ops = [block_tridiag_qp(40, s, dtype=torch.float64) for s in seeds]
    op = BlockSparseOperator(torch.cat([o.blocks for o, _, _ in ops]),
                             torch.cat([o.cols for o, _, _ in ops]))
    rt = solve_batched_fused_compact("pcg", op, torch.cat([b for _, b, _ in ops]), 5,
                                     proj=proj_from_jax(jproj), config=config_from_jax(jcfg),
                                     bucket=4, host_fallback=False)
    assert bool(np.asarray(rj.converged).all()) and bool((rt.matvecs > 5).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_operator_on_cuda_matches_cpu(cuda, dtype):
    """On the card the operator stays on the card and computes what it
    computes on the CPU (exact products, the same sum order per block;
    rel 1e-6 in f32, 1e-15 in f64), and launches no GEMV."""
    blocks, cols = random_ell(6, B=3, nbr=50)
    cpu = BlockSparseOperator(torch.from_numpy(blocks).to(dtype), torch.from_numpy(cols))
    dev = BlockSparseOperator(cpu.blocks.to(cuda), cpu.cols.to(cuda))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((3, cpu.n))).to(dtype)
    before = gemv.LAUNCHES
    y = dev.matvec(x.to(cuda))
    assert y.is_cuda and y.dtype == dtype and gemv.LAUNCHES == before
    ref = cpu.matvec(x)
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    assert float((y.cpu() - ref).abs().max() / ref.abs().max()) < tol
    assert torch.equal(dev.diagonal().cpu(), cpu.diagonal())
    torch.testing.assert_close(dev.inf_norm().cpu(), cpu.inf_norm(), rtol=tol, atol=0)
    assert torch.equal(dev.take(torch.tensor([1], device=cuda)).blocks.cpu(), cpu.blocks[[1]])


@pytest.mark.cuda
def test_huge_qp_pcg_on_cuda_matches_cpu(cuda):
    """The huge-QP family at n = 4000 in f64 on the card against the CPU:
    equal counts, x within 1e-10."""
    op, b, _ = block_tridiag_qp(4000, 0, dtype=torch.float64)
    proj = proj_from_jax(JP.box(-np.ones(4000), np.ones(4000), dtype=jnp.float64))
    cfg = config_from_jax(JaxPCGConfig(tol=1e-10, max_matvecs=2000))
    r_cpu = pcg.solve(op, b, proj=proj, config=cfg)
    op_d, b_d, _ = block_tridiag_qp(4000, 0, dtype=torch.float64, device=cuda)
    r = pcg.solve(op_d, b_d, proj=proj.to(cuda), config=cfg)
    assert bool(r.converged.all()) and torch.equal(r.matvecs.cpu(), r_cpu.matvecs)
    np.testing.assert_allclose(r.x.cpu().numpy(), r_cpu.x.numpy(), rtol=0, atol=1e-10)
