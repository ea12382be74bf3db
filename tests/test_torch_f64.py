"""Port parity: f64 on the card's path -- the f64-exact rung
(``MixedPrecDense`` with f64 ``A`` and f32 ``A_low``) and the f64
``DenseOperator`` -- against ccqppy_tpu, on the CPU in f64, per lane.

The rung's cheap sweep is an f32 GEMV (f32 products, f32 sums) in both
packages, and the two sum in different orders: the sweeps differ by
~n 2^-24 relative, so the trajectories part from the first segment (x by
~1e-6 after two segments of 16).  On a raw Wishart lane (condition 1e3 to
1e7 at n=48) CG amplifies that: measured at seeds 0-7, n=48, tol 1e-8,
the two packages' matvec counts part by up to ~6,000 on a lane, and at a
budget of 20,000 four lanes of 32 converge in one package only.  The same
holds for JAX against itself: any change in the f32 sums' order does it.
So the tests hold per-lane parity where it is defined: over the first
segments (equal matvec and iteration counts, so every segment ends at the
same step, x within the f32 sweep's reach), and at convergence the
guarantee itself (equal ``converged``, a fresh f64 residual under tol in
both, x within the residual's bound on |x - x*|).  The f64 DenseOperator
has no f32 step: on a raw Wishart lanes of moderate condition it matches per
lane in counts and to 1e-10 in x.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.ops import linop as JL
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import pcg
from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import DenseOperator, MixedPrecDense
from ccqppy_tpu_torch.utils.convert import config_from_jax, operator_from_jax, proj_from_jax

torch.set_num_threads(1)

B, N = 4, 48
REFRESH, DROP = 16, 0.25     # the issue's rung test: refresh every 16, drop 0.25


def wishart(seed, B=B, n=N):
    """The reference generator's raw Wishart family: A = G G^T,
    b = -A x_uncon, x_uncon ~ U(-1, 1), in f64."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = G @ G.transpose(0, 2, 1)
    return A, -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (B, n)))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def jacobi(A, b):
    return np.clip(-b / np.diagonal(A, axis1=1, axis2=2), -1.0, 1.0)


def both(A, b, jcfg, rung):
    """One batched PCG in each package from the Jacobi start on the box
    [-1, 1]: on the rung pair (A f64, A_low f32) or on the f64 stack."""
    n = A.shape[-1]
    jproj = JP.box(-np.ones(n), np.ones(n), dtype=jnp.float64)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    jop = JL.MixedPrecDense(Aj, Aj.astype(jnp.float32)) if rung else Aj
    op = MixedPrecDense(At, At.float()) if rung else DenseOperator(At)
    x0 = jacobi(A, b)
    rj = solve_batched("pcg", jop, jnp.asarray(b), x0=jnp.asarray(x0), proj=jproj, config=jcfg)
    rt = pcg.solve(op, torch.from_numpy(b), x0=torch.from_numpy(x0), proj=proj_from_jax(jproj),
                   config=config_from_jax(jcfg))
    return rj, rt, proj_from_jax(jproj)


# ------------------------------------------------------------------ operators

@pytest.mark.parametrize("xdtype", [np.float32, np.float64], ids=["x-f32", "x-f64"])
def test_rung_operator_matches_jax(xdtype):
    """The cheap sweep rounds x to f32 and sums in f32 whatever x's dtype
    (rel 1e-6: the f32 sums' order), cast back to x's dtype; the exact sweep
    is f64 (rel 1e-15 for an f64 x)."""
    A, _ = wishart(1)
    x = np.random.default_rng(2).standard_normal((B, N)).astype(xdtype)
    Aj = jnp.asarray(A)
    op = MixedPrecDense(torch.from_numpy(A), torch.from_numpy(A).float())
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    y, ye = op.matvec(xt), op.matvec_exact(xt)
    yj = jax.vmap(lambda a, lo, v: JL.MixedPrecDense(a, lo).matvec(v))(Aj, Aj.astype(jnp.float32), xj)
    yej = jax.vmap(lambda a, lo, v: JL.MixedPrecDense(a, lo).matvec_exact(v))(
        Aj, Aj.astype(jnp.float32), xj)
    assert y.dtype == xt.dtype and yj.dtype == x.dtype
    assert rel(y.numpy(), yj) < 1e-6
    # The cheap sweep is f32-grade against the exact one.
    exact = np.einsum("bij,bj->bi", A, x.astype(np.float64))
    assert 1e-9 < rel(y.numpy(), exact) < 1e-5
    if xdtype == np.float64:
        assert ye.dtype == torch.float64 and rel(ye.numpy(), yej) < 1e-15
    np.testing.assert_array_equal(op.diagonal().numpy(), np.diagonal(A, axis1=1, axis2=2))
    np.testing.assert_allclose(op.inf_norm().numpy(),
                               np.asarray(jax.vmap(lambda a: JL.MixedPrecDense(a, a.astype(jnp.float32)).inf_norm())(Aj)),
                               rtol=1e-14)
    sub = op.take(torch.tensor([3, 0]))
    assert torch.equal(sub.A, op.A[[3, 0]]) and sub.A_low.dtype == torch.float32


@pytest.mark.parametrize("pair", [(torch.float32, torch.bfloat16), (torch.float64, torch.float32)],
                         ids=["f32-bf16", "f64-f32"])
def test_operator_from_jax_carries_each_pair(pair):
    A, _ = wishart(3, B=2, n=8)
    hi, lo = (jnp.float32, jnp.bfloat16) if pair[0] == torch.float32 else (jnp.float64, jnp.float32)
    jop = JL.MixedPrecDense(jnp.asarray(A, hi), jnp.asarray(A, hi).astype(lo))
    op = operator_from_jax(jop, "cpu", torch.float64)
    assert (op.A.dtype, op.A_low.dtype) == pair
    np.testing.assert_array_equal(op.A.double().numpy(), np.asarray(jop.A, np.float64))
    np.testing.assert_array_equal(op.A_low.double().numpy(), np.asarray(jop.A_low, np.float64))


# ----------------------------------------------------------------- the rung

def test_rung_first_segments_match_jax_per_lane():
    """Two segments and their refreshes (a budget of 34): per lane equal
    matvec and iteration counts (each segment ends at the same step, on
    ``segment_drop`` against the f64 residual or at 16), equal
    ``converged``; x within 1e-5 and the refresh residuals within 1e-4
    relative, the reach of two segments of f32 sweeps summed in another
    order (measured 2.2e-6 and 1.2e-5 at this seed)."""
    A, b = wishart(0)
    jcfg = JaxPCGConfig(tol=1e-8, max_matvecs=34, refresh_every=REFRESH, segment_drop=DROP,
                        trace_len=4)
    rj, rt, _ = both(A, b, jcfg, rung=True)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert rt.x.dtype == torch.float64 and rt.residual.dtype == torch.float64
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-4)


def moderate_lanes():
    """Four raw Wishart lanes of condition 1.8e3-6.0e3 (lane 2 of seeds 0,
    2, 3 and 7), where the two packages' trajectories do not part."""
    pairs = [wishart(seed) for seed in (0, 2, 3, 7)]
    return np.stack([A[2] for A, _ in pairs]), np.stack([b[2] for _, b in pairs])


@pytest.mark.parametrize("tol", [1e-8, 1e-10])
def test_rung_matches_jax_per_lane(tol):
    """The rung (refresh 16, drop 0.25) on raw Wishart lanes of moderate
    condition: per lane equal ``converged``, matvec and iteration counts
    (equal, not merely within a segment: on these lanes the f32 sums' order
    does not part the trajectories), the residual within 5% of tol and x
    within 10 tol (measured 1.2e-8 at tol 1e-8, 5.4e-11 at 1e-10).  At
    1e-10 the lanes reach four decades below the ~2e-5 where f32 iterates
    floor on this family (the JAX benchmark's note): the state is carried
    in f64 over the f32 sweeps."""
    A, b = moderate_lanes()
    jcfg = JaxPCGConfig(tol=tol, max_matvecs=20_000, refresh_every=REFRESH, segment_drop=DROP)
    rj, rt, _ = both(A, b, jcfg, rung=True)
    assert bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert rt.x.dtype == torch.float64
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual), rtol=0,
                               atol=0.05 * tol)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=10 * tol)


def test_rung_keeps_the_guarantee_where_trajectories_part():
    """The rung to tol 1e-8 on the raw Wishart family at seed 5 (condition
    2.8e3-5.1e4), where every lane of both packages converges within 20,000
    matvecs (at seeds 1-4 some lane does not, in one package or the other;
    see the module docstring).  Per lane: equal ``converged``; a fresh f64
    residual under tol in both; x within 2 x 3 n tol / lambda_min of each
    other, twice the Eq. 25 bound on |x - x*|; matvec counts, which the f32
    sums' order parts (measured 633/575, 8457/9055, 1408/1311, 2230/2134),
    within 25% of each other."""
    tol = 1e-8
    A, b = wishart(5)
    jcfg = JaxPCGConfig(tol=tol, max_matvecs=20_000, refresh_every=REFRESH, segment_drop=DROP)
    rj, rt, proj = both(A, b, jcfg, rung=True)
    assert bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for x in (rt.x, torch.from_numpy(np.array(rj.x))):
        fresh = pg_residual(proj, x, gemv.batched_gemv(At, x) + bt, 1e-6)
        assert bool((fresh < tol).all())
    bound = 2 * 3 * N * tol / np.linalg.eigvalsh(A)[:, 0]
    assert (np.abs(rt.x.numpy() - np.asarray(rj.x)).max(axis=1) < bound).all()
    mt, mj = rt.matvecs.numpy(), np.asarray(rj.matvecs)
    assert (np.abs(mt - mj) <= 0.25 * mj).all()


# ------------------------------------------------------- the f64 dense solve

@pytest.mark.parametrize("tol", [1e-8, 1e-10])
def test_f64_dense_pcg_matches_jax_per_lane(tol):
    """Plain PCG on an f64 DenseOperator (the JAX package's f64 dense solve)
    on the rung test's lanes: per lane equal ``converged`` and matvec
    counts, x within 1e-10 (measured 5.1e-11 and 8.8e-13).  Plain f64 CG
    parts too where the conditioning is worse (seeds 2 and 3 at n=48, lanes
    of condition 1e6-1e7: 301 against 351, 317 against 482 matvecs at tol
    1e-8), with no f32 step at all.  On these lanes it needs 92-143 sweeps
    where the rung needs 617-4109."""
    A, b = moderate_lanes()
    jcfg = JaxPCGConfig(tol=tol, max_matvecs=5000)
    rj, rt, _ = both(A, b, jcfg, rung=False)
    assert bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _offset_view(t, offset):
    """t's values at a storage offset, NaN before them and in 16 bytes after."""
    pad = 16 // t.element_size()
    buf = torch.full((offset + t.numel() + pad,), torch.nan, dtype=t.dtype, device=t.device)
    buf[offset:offset + t.numel()] = t.reshape(-1)
    return buf[offset:offset + t.numel()].view(t.shape)


F64_TOL = 1e-13   # max|y - y_ref| / max|y_ref|: f64 sums of n products in another order


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 1), (3, 31), (3, 999), (2, 1000), (64, 1000), (2, 1025)])
def test_f64_kernel_matches_plain_on_cuda(cuda, B, n):
    """The f64 instance against the plain f64 version at awkward n, two
    launches bitwise equal, and bitwise equal at storage offsets of A and x
    (NaN around both) of 0-1 elements (16 bytes hold two f64)."""
    gen = torch.Generator(device=cuda).manual_seed(B * 1009 + n)
    A = torch.randn((B, n, n), generator=gen, device=cuda, dtype=torch.float64)
    x = torch.randn((B, n), generator=gen, device=cuda, dtype=torch.float64)
    before = (gemv.LAUNCHES, gemv.LAUNCHES_F64)
    y = gemv.batched_gemv(A, x)
    torch.cuda.synchronize()
    assert (gemv.LAUNCHES, gemv.LAUNCHES_F64) == (before[0] + 1, before[1] + 1)
    assert y.dtype == torch.float64
    ref = gemv.batched_gemv_reference(A, x)
    assert float((y - ref).abs().max() / ref.abs().max()) < F64_TOL
    assert torch.equal(gemv.batched_gemv(A, x).view(torch.int64), y.view(torch.int64))
    for a_off in (0, 1):
        for x_off in (0, 1):
            y_off = gemv.batched_gemv(_offset_view(A, a_off), _offset_view(x, x_off))
            assert torch.equal(y_off.view(torch.int64), y.view(torch.int64)), (a_off, x_off)


GEOMETRY_SHAPES = [(B, n) for B in (1, 3) for n in (1, 3, 31, 33, 999, 1000, 1024, 1025, 2049)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", GEOMETRY_SHAPES, ids=[f"B{B}-n{n}" for B, n in GEOMETRY_SHAPES])
def test_f64_kernel_tiles_and_offsets_on_cuda(cuda, B, n):
    """The f64 instance (column tiles of 512 elements: one at n <= 512, two
    at 1000 and 1024, three at 1025, five at 2049; rows not 16-byte
    aligned; rows at the tensor's ends) against the plain f64 version, and
    bitwise the same at storage offsets 0-3 of A and of x, with NaN around
    both."""
    gen = torch.Generator(device=cuda).manual_seed(B * 7919 + n)
    A = torch.randn((B, n, n), generator=gen, device=cuda, dtype=torch.float64)
    x = torch.randn((B, n), generator=gen, device=cuda, dtype=torch.float64)
    y = gemv.batched_gemv(A, x)
    ref = gemv.batched_gemv_reference(A, x)
    assert float((y - ref).abs().max() / ref.abs().max()) < F64_TOL
    for a_off in range(4):
        for x_off in range(4):
            y_off = gemv.batched_gemv(_offset_view(A, a_off), _offset_view(x, x_off))
            assert torch.equal(y_off.view(torch.int64), y.view(torch.int64)), (a_off, x_off)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rung_on_cuda_launches_both_instances(cuda):
    """MixedPrecDense(f64, f32) on the card: the cheap sweep is one f32
    launch (f64 x in, f64 out), the exact sweep one f64 launch; nothing runs
    on the CPU.  The rung's PCG on the card converges to a fresh f64
    residual under tol, as on the CPU."""
    A, b = moderate_lanes()
    At, bt = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    op = MixedPrecDense(At, At.float())
    x = torch.from_numpy(jacobi(A, b)).to(cuda)
    before = (gemv.LAUNCHES, gemv.LAUNCHES_F64, gemv.LAUNCHES_BF16)
    y, ye = op.matvec(x), op.matvec_exact(x)
    assert (gemv.LAUNCHES - before[0], gemv.LAUNCHES_F64 - before[1],
            gemv.LAUNCHES_BF16 - before[2]) == (2, 1, 0)
    assert y.dtype == ye.dtype == torch.float64 and y.is_cuda
    ref = gemv.batched_gemv_reference(At, x)
    assert float((ye - ref).abs().max() / ref.abs().max()) < F64_TOL
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-5
    proj = proj_from_jax(JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64)).to(cuda)
    cfg = config_from_jax(JaxPCGConfig(tol=1e-8, max_matvecs=20_000, refresh_every=REFRESH,
                                       segment_drop=DROP))
    r = pcg.solve(op, bt, x0=x, proj=proj, config=cfg)
    assert bool(r.converged.all())
    fresh = pg_residual(proj, r.x, gemv.batched_gemv_reference(At, r.x) + bt, 1e-6)
    assert float(fresh.max()) < 1e-8


@pytest.mark.cuda
def test_f64_dense_pcg_on_cuda_matches_cpu(cuda):
    """Plain PCG on the f64 DenseOperator on the card (the f64 instance)
    against the CPU: per lane equal counts, x within 1e-10."""
    A, b = moderate_lanes()
    jcfg = JaxPCGConfig(tol=1e-10, max_matvecs=5000)
    proj = proj_from_jax(JP.box(-np.ones(N), np.ones(N), dtype=jnp.float64))
    x0 = torch.from_numpy(jacobi(A, b))
    r_cpu = pcg.solve(torch.from_numpy(A), torch.from_numpy(b), x0=x0, proj=proj,
                      config=config_from_jax(jcfg))
    before = gemv.LAUNCHES_F64
    r = pcg.solve(torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda), x0=x0.to(cuda),
                  proj=proj.to(cuda), config=config_from_jax(jcfg))
    assert gemv.LAUNCHES_F64 - before >= int(r.matvecs.max())
    assert torch.equal(r.matvecs.cpu(), r_cpu.matvecs)
    np.testing.assert_allclose(r.x.cpu().numpy(), r_cpu.x.numpy(), rtol=0, atol=1e-10)


# ------------------------------------------------------- chip_smoke.py's (j)

def _load(name, path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rung_mode_matches_benchmark_wiring():
    """Mode (j) of chip_smoke.py wired as ``benchmarks/benchmark_f64_wishart1k.py``
    wires one dispatch (the Jacobi start, ``MixedPrecDense(A, A.astype(f32))``,
    its refresh and segment drop, the box [-1, 1]) at tol 1e-8: per lane
    equal ``converged`` and matvec counts, x within 10 tol; plain f64 PCG
    beside it likewise, x within 1e-10.  On the bench family A = G G^T + n I
    (condition ~5): with segments of up to 128 f32 sweeps the trajectories
    part even on the moderate raw lanes (280 against 288 matvecs)."""
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    bench = _load("benchmark_f64_wishart1k", root / "benchmarks" / "benchmark_f64_wishart1k.py")
    cs = _load("chip_smoke", root / "chip_smoke.py")
    assert (cs.B_F64, cs.N, cs.REFRESH_F64, cs.SEGMENT_DROP_F64) == \
        (bench.B, bench.N, bench.REFRESH, bench.SEGMENT_DROP)
    assert (cs.TOL_F64, cs.BUDGET_F64) == bench.TOLS[0]
    tol = 1e-8
    rng = np.random.default_rng(11)
    G = rng.standard_normal((B, N, N))
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (B, N)))
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    jproj = JP.box(-jnp.ones(N, jnp.float64), jnp.ones(N, jnp.float64))
    x0 = jnp.clip(-bj / jnp.diagonal(Aj, axis1=-2, axis2=-1), -1.0, 1.0)
    from ccqppy_tpu.models.pcg import solve as jax_pcg_solve
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    diag = At.diagonal(dim1=-2, dim2=-1)
    proj = proj_from_jax(jproj)
    for rung in (True, False):
        jcfg = JaxPCGConfig(tol=tol, max_matvecs=20_000, refresh_every=bench.REFRESH if rung else 0,
                            segment_drop=bench.SEGMENT_DROP if rung else 0.0)
        rj = jax.vmap(lambda a, bb, x: jax_pcg_solve(
            JL.MixedPrecDense(a, a.astype(jnp.float32)) if rung else JL.DenseOperator(a), bb,
            x0=x, proj=jproj, config=jcfg))(Aj, bj, x0)
        cfg = config_from_jax(jcfg)
        rt = (cs.run_rung(At, At.float(), bt, diag, proj, cfg) if rung
              else cs.run_f64_plain(At, bt, diag, proj, cfg))
        assert bool(np.asarray(rj.converged).all())
        np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
        np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                                   atol=10 * tol if rung else 1e-10)
