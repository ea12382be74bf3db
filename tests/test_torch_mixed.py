"""Port parity: the precision ladder of ccqppy_tpu_torch against ccqppy_tpu's.

``CastDense``, ``MixedPrecDense`` and ``FastDense`` (ops/linop.py),
residual-replacement PCG (``PCGConfig.refresh_every > 0``) and
``solve_batched_mixed`` / ``prepare_dense_batch`` (parallel/mixed.py), on
the CPU in f64 iterates over f32 and bf16 stacks, per lane.

Both packages round an f64 x to bf16 through f32 (twice), bitwise alike
(``test_bf16_rounding_of_x_matches_xla``), and multiply bf16 values exactly
in f64; only the order of the sums differs.  So per lane the two agree in
``converged``, matvec and iteration counts, and in x to 1e-10 on the box.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccqppy_tpu.models import BBPGDfConfig as JaxBBPGDfConfig
from ccqppy_tpu.models import PCGConfig as JaxPCGConfig
from ccqppy_tpu.ops import linop as JL
from ccqppy_tpu.ops import projections as JP
from ccqppy_tpu.parallel import prepare_dense_batch as jax_prepare_dense_batch
from ccqppy_tpu.parallel import solve_batched_mixed as jax_solve_batched_mixed
from ccqppy_tpu.parallel.batch import solve_batched
from ccqppy_tpu_torch.models import SOLVERS, pcg
from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import (CastDense, DenseOperator, FastDense,
                                        MixedPrecDense, SpectralDense)
from ccqppy_tpu_torch.parallel import prepare_dense_batch, solve_batched_mixed
from ccqppy_tpu_torch.utils.convert import (config_from_jax, operator_from_jax,
                                            proj_from_jax)

torch.set_num_threads(1)

B, N = 8, 48


def family(seed, B=B, n=N, scale=1.5):
    """A = G G^T + n I in f32 (as a user's stack), b in f64 with many active
    bounds on [-1, 1] (x_uncon ~ U(-scale, scale)); lane 0 is interior."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    A = (G @ G.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    xu = rng.uniform(-scale, scale, (B, n))
    xu[0] = rng.uniform(-0.5, 0.5, n)
    return A, -np.einsum("bij,bj->bi", A.astype(np.float64), xu)


def jax_box(n=N):
    return JP.box(-np.ones(n), np.ones(n), dtype=jnp.float64)


def bf16(A):
    """The bf16 copies of an f32 numpy stack in both packages."""
    return jnp.asarray(A).astype(jnp.bfloat16), torch.from_numpy(A).to(torch.bfloat16)


def assert_lanes_match(rj, rt, xtol=1e-10, restol=1e-12):
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.matvecs.numpy(), np.asarray(rj.matvecs))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=xtol, atol=xtol)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=1e-9, atol=restol)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ------------------------------------------------------------------ operators

@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_bf16_rounding_of_x_matches_xla(dtype):
    """torch and XLA round an x of either dtype to the same bf16 values
    (an f64 x through f32 in both), bitwise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(20000).astype(dtype)
    # Values just off a bf16 half-way point, where one rounding and two differ.
    mid = (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    x = np.concatenate([x, mid.view(np.float32).astype(dtype) * (1 + 2.0**-40)])
    t = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("xdtype", [np.float32, np.float64], ids=["x-f32", "x-f64"])
def test_cast_dense_matches_jax(xdtype):
    A, _ = family(1)
    x = np.random.default_rng(2).standard_normal((B, N)).astype(xdtype)
    Aj, At = bf16(A)
    op = CastDense(At)
    y = op.matvec(torch.from_numpy(x))
    yj = jax.vmap(lambda a, v: JL.CastDense(a).matvec(v))(Aj, jnp.asarray(x))
    assert y.dtype == torch.from_numpy(x).dtype and yj.dtype == x.dtype
    # bf16 products are exact in either sum dtype; only the order differs.
    assert rel(y.numpy(), yj) < (1e-6 if xdtype == np.float32 else 1e-15)
    assert op.diagonal().dtype == torch.float32
    np.testing.assert_array_equal(op.diagonal().numpy(),
                                  np.asarray(jax.vmap(lambda a: JL.CastDense(a).diagonal())(Aj)))
    np.testing.assert_allclose(op.inf_norm().numpy(),
                               np.asarray(jax.vmap(lambda a: JL.CastDense(a).inf_norm())(Aj)),
                               rtol=1e-6)
    idx = torch.tensor([5, 1])
    assert torch.equal(op.take(idx).matvec(torch.from_numpy(x)[idx]), y[idx])
    assert torch.equal(CastDense.from_f32(torch.from_numpy(A)).A, At)


@pytest.mark.parametrize("xdtype", [np.float32, np.float64], ids=["x-f32", "x-f64"])
def test_mixed_prec_dense_matches_jax(xdtype):
    A, _ = family(3)
    x = np.random.default_rng(4).standard_normal((B, N)).astype(xdtype)
    Aj_low, At_low = bf16(A)
    op = MixedPrecDense(torch.from_numpy(A), At_low)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    jop = lambda a, lo: JL.MixedPrecDense(a, lo)  # noqa: E731
    y = op.matvec(xt)
    yj = jax.vmap(lambda a, lo, v: jop(a, lo).matvec(v))(jnp.asarray(A), Aj_low, xj)
    ye = op.matvec_exact(xt)
    yej = jax.vmap(lambda a, lo, v: jop(a, lo).matvec_exact(v))(jnp.asarray(A), Aj_low, xj)
    assert y.dtype == ye.dtype == xt.dtype
    tol = 1e-6 if xdtype == np.float32 else 1e-15
    assert rel(y.numpy(), yj) < tol and rel(ye.numpy(), yej) < tol
    # The cheap sweep is the bf16 one: it differs from the exact one.
    assert rel(y.numpy(), ye.numpy()) > 1e-4
    np.testing.assert_array_equal(op.diagonal().numpy(), np.diagonal(A, axis1=1, axis2=2))
    idx = torch.tensor([0, 7, 3])
    sub = op.take(idx)
    assert torch.equal(sub.A, op.A[idx]) and torch.equal(sub.A_low, op.A_low[idx])
    assert torch.equal(MixedPrecDense.from_f32(torch.from_numpy(A)).A_low, At_low)


def test_fast_dense_sweeps_are_the_exact_sweep():
    """On the H100 the f32 kernel has no cheap tier: both sweeps of
    FastDense are the exact one, as the JAX FastDense's HIGHEST sweep."""
    A, _ = family(5)
    x = np.random.default_rng(6).standard_normal((B, N))
    op = FastDense(torch.from_numpy(A))
    xt = torch.from_numpy(x)
    assert torch.equal(op.matvec(xt), op.matvec_exact(xt))
    assert torch.equal(op.matvec(xt), DenseOperator(torch.from_numpy(A)).matvec(xt))
    yj = jax.vmap(lambda a, v: JL.FastDense(a).matvec_exact(v))(jnp.asarray(A), jnp.asarray(x))
    assert rel(op.matvec(xt).numpy(), yj) < 1e-15
    assert isinstance(op.take(torch.tensor([1])), FastDense)


def test_dense_operator_rejects_bf16_naming_cast_dense():
    """Queue-3 fault 1: a bf16 stack would round x to bf16, which is
    CastDense's matvec, not DenseOperator's."""
    A = torch.zeros((2, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="CastDense"):
        DenseOperator(A)
    with pytest.raises(TypeError, match="CastDense"):
        SpectralDense(A, torch.ones(2), torch.ones(2))
    with pytest.raises(TypeError):
        CastDense(torch.zeros((2, 4, 4)))


def test_f32_stack_with_f64_x_is_f64():
    """Queue-3 fault 2: an f32 stack and an f64 iterate give an f64 product,
    as the JAX DenseOperator's does."""
    A, _ = family(7)
    x = np.random.default_rng(8).standard_normal((B, N))
    y = gemv.batched_gemv_reference(torch.from_numpy(A), torch.from_numpy(x))
    assert y.dtype == torch.float64
    yj = jax.vmap(lambda a, v: JL.DenseOperator(a).matvec(v))(jnp.asarray(A), jnp.asarray(x))
    assert yj.dtype == jnp.float64
    assert rel(y.numpy(), yj) < 1e-15
    assert DenseOperator(torch.from_numpy(A)).matvec(torch.from_numpy(x)).dtype == torch.float64


@pytest.mark.parametrize("hi,lo,ok", [
    (torch.float32, torch.bfloat16, True),    # the bf16 -> f32 ladder
    (torch.float64, torch.float32, True),     # the f64-exact rung
    (torch.float32, torch.float32, False),
    (torch.float64, torch.bfloat16, False),
], ids=["f32-bf16", "f64-f32", "f32-f32", "f64-bf16"])
def test_mixed_prec_dense_dtype_pairs(hi, lo, ok):
    """The two pairs the JAX package runs build; any other raises."""
    A = torch.eye(4, dtype=hi).expand(2, 4, 4).contiguous()
    if ok:
        op = MixedPrecDense(A, A.to(lo))
        assert (op.A.dtype, op.A_low.dtype) == (hi, lo)
        assert op.matvec(torch.ones((2, 4), dtype=hi)).dtype == hi
    else:
        with pytest.raises(TypeError):
            MixedPrecDense(A, A.to(lo))


@pytest.mark.parametrize("kind", ["CastDense", "MixedPrecDense", "FastDense"])
def test_operator_from_jax(kind):
    A, _ = family(9, B=3, n=16)
    Aj = jnp.asarray(A)
    jop = {"CastDense": lambda: JL.CastDense(Aj.astype(jnp.bfloat16)),
           "MixedPrecDense": lambda: JL.MixedPrecDense(Aj, Aj.astype(jnp.bfloat16)),
           "FastDense": lambda: JL.FastDense(Aj)}[kind]()
    op = operator_from_jax(jop, "cpu", torch.float32)
    assert type(op).__name__ == kind
    stacks = {"CastDense": ("A",), "MixedPrecDense": ("A", "A_low"), "FastDense": ("A",)}[kind]
    for name in stacks:
        t, a = getattr(op, name), np.asarray(getattr(jop, name))
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


# ----------------------------------------------------- residual-replacement PCG

def rr_both(op_kind, A, b, jcfg):
    jproj = jax_box()
    Aj = jnp.asarray(A)
    if op_kind == "mixed":
        jop = JL.MixedPrecDense(Aj, Aj.astype(jnp.bfloat16))
        op = MixedPrecDense(torch.from_numpy(A), torch.from_numpy(A).to(torch.bfloat16))
    else:
        jop, op = Aj, torch.from_numpy(A)
    rj = solve_batched("pcg", jop, jnp.asarray(b), proj=jproj, config=jcfg)
    rt = pcg.solve(op, torch.from_numpy(b), proj=proj_from_jax(jproj),
                   config=config_from_jax(jcfg))
    return rj, rt


@pytest.mark.parametrize("restart,drop", [(True, 0.0), (False, 0.0), (True, 3e-2),
                                          (False, 3e-2)],
                         ids=["restart", "keep-p", "restart-drop", "keep-p-drop"])
def test_rr_pcg_matches_jax(restart, drop):
    """Keep-p without a segment drop spends the whole budget on most lanes,
    as the JAX package documents.  x agrees to ~2e-11: the cheap sweeps'
    sums differ in order by ~1e-16 and CG carries that along; the residual,
    a gradient of A (~5n) times x, agrees to 5% of tol."""
    tol = 1e-9
    A, b = family(11)
    jcfg = JaxPCGConfig(tol=tol, max_matvecs=1500, refresh_every=16,
                        refresh_restart=restart, segment_drop=drop, trace_len=10)
    rj, rt = rr_both("mixed", A, b, jcfg)
    assert bool(np.asarray(rj.converged).any())
    assert len(set(np.asarray(rj.matvecs).tolist())) > 2     # lanes differ
    assert_lanes_match(rj, rt, restol=0.05 * tol)
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_rr_pcg_on_exact_operator_matches_jax(precond):
    """refresh_every > 0 on a plain operator (matvec_exact == matvec)."""
    A, b = family(12)
    jcfg = JaxPCGConfig(tol=1e-10, max_matvecs=1500, refresh_every=7, precond=precond)
    rj, rt = rr_both("dense", A.astype(np.float64), b, jcfg)
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt)


def test_rr_pcg_budget_exhaustion_matches_jax():
    """A lane at budget - 1 after a refresh still opens a segment (the
    JAX package checks ``mv >= budget`` there), takes one cheap sweep and its
    refresh: both packages end at budget + 1."""
    A, b = family(13)
    jcfg = JaxPCGConfig(tol=1e-13, max_matvecs=20, refresh_every=8)
    rj, rt = rr_both("mixed", A, b, jcfg)
    assert not bool(np.asarray(rj.converged).any())
    assert int(rt.matvecs.max()) == 21
    assert_lanes_match(rj, rt)


# --------------------------------------------------------- solve_batched_mixed

def ladder_both(A, b, jcfg, **kw):
    jproj = jax_box()
    x0 = kw.pop("x0", None)
    rj = jax_solve_batched_mixed(jnp.asarray(A), jnp.asarray(b), proj=jproj, config=jcfg,
                                 x0=None if x0 is None else jnp.asarray(x0), **kw)
    rt = solve_batched_mixed(torch.from_numpy(A), torch.from_numpy(b),
                             proj=proj_from_jax(jproj), config=config_from_jax(jcfg),
                             x0=None if x0 is None else torch.from_numpy(x0), **kw)
    return rj, rt


@pytest.mark.parametrize("fixup", [True, False])
def test_ladder_matches_jax(fixup):
    """With a polish budget short enough to leave stragglers, so that the
    fixup has lanes to finish."""
    A, b = family(21, scale=3.0)
    jcfg = JaxBBPGDfConfig(tol=1e-9, max_matvecs=45)
    rj, rt = ladder_both(A, b, jcfg, phase_a_budget=30, fixup=fixup)
    assert_lanes_match(rj, rt)
    if fixup:
        _, r_nofix = ladder_both(A, b, jcfg, phase_a_budget=30, fixup=False)
        assert not bool(r_nofix.converged.all())            # stragglers
        assert bool(rt.converged.all())                     # all finished
        assert bool((rt.matvecs > r_nofix.matvecs).any())   # fixup counted


def test_ladder_warm_start_matches_jax():
    A, b = family(22)
    jcfg = JaxBBPGDfConfig(tol=1e-9, max_matvecs=600)
    _, r1 = ladder_both(A, b, jcfg)
    x0 = r1.x.numpy() + 1e-3 * np.random.default_rng(23).standard_normal(r1.x.shape)
    rj, rt = ladder_both(A, b, jcfg, x0=x0, phase_a_tol=1e-2, phase_a_budget=20)
    assert bool(np.asarray(rj.converged).all())
    assert_lanes_match(rj, rt)


def test_ladder_phase_a_alone_cannot_converge_a_lane():
    """Phase A's residual is that of the bf16 operator: run alone at its
    tol it claims every lane, and some claims are false against the exact
    operator.  In the ladder only exact residuals decide: with 4 polish
    sweeps no lane reaches tol 1e-6, none is reported converged, and each
    reported residual is the exact one."""
    A, b = family(24)
    bt = torch.from_numpy(b)
    proj = proj_from_jax(jax_box())
    exact = DenseOperator(torch.from_numpy(A))
    ra = SOLVERS["bbpgd_f"][0](CastDense(bf16(A)[1]), bt, proj=proj,
                               config=SOLVERS["bbpgd_f"][1](tol=5e-3, max_matvecs=48))
    assert bool(ra.converged.all())
    true_a = pg_residual(proj, ra.x, exact.matvec(ra.x) + bt, 1e-6)
    assert bool((true_a > 5e-3).any())              # a false claim
    rj, rt = ladder_both(A, b, JaxBBPGDfConfig(tol=1e-6, max_matvecs=52), fixup=False)
    assert_lanes_match(rj, rt)
    assert not bool(rt.converged.any())
    true_t = pg_residual(proj, rt.x, exact.matvec(rt.x) + bt, 1e-6)
    np.testing.assert_allclose(rt.residual.numpy(), true_t.numpy(), rtol=1e-12)


def test_phase_a_floors_above_its_default_tol_in_both_packages():
    """In f32, phase A's own residual has a floor: each cheap sweep rounds x
    to bf16, so the gradient it sees moves by ~2^-9 |A| |x| however close x
    comes.  On this family at n=300 the floor lies near 1e-2 in both
    packages, above the ladder's default phase_a_tol of 5e-3, so phase A
    spends its whole default budget of 48 sweeps on every lane."""
    n = 300
    rng = np.random.default_rng(40)
    G = rng.standard_normal((2, n, n))
    A = (G @ G.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    b = -np.einsum("bij,bj->bi", A, rng.uniform(-1, 1, (2, n))).astype(np.float32)
    jproj = JP.box(-np.ones(n, np.float32), np.ones(n, np.float32), dtype=jnp.float32)
    jcfg = JaxBBPGDfConfig(tol=5e-3, max_matvecs=48, trace_len=48)
    Aj16, At16 = bf16(A)
    rj = solve_batched("bbpgd_f", JL.CastDense(Aj16), jnp.asarray(b), proj=jproj, config=jcfg)
    rt = SOLVERS["bbpgd_f"][0](CastDense(At16), torch.from_numpy(b), proj=proj_from_jax(jproj),
                               config=config_from_jax(jcfg))
    for r in (rj, rt):
        np.testing.assert_array_equal(np.asarray(r.matvecs), 48)
        assert not np.asarray(r.converged).any()
        assert np.nanmin(np.asarray(r.trace)) > 5e-3


def test_ladder_takes_a_given_bf16_copy():
    A, b = family(25)
    jcfg = JaxBBPGDfConfig(tol=1e-9, max_matvecs=600)
    _, r_auto = ladder_both(A, b, jcfg)
    As, As16 = prepare_dense_batch(torch.from_numpy(A), torch.bfloat16)
    r = solve_batched_mixed(As, torch.from_numpy(b), proj=proj_from_jax(jax_box()),
                            config=config_from_jax(jcfg), As_low=As16)
    for f in ("x", "residual", "converged", "matvecs", "iterations"):
        assert torch.equal(getattr(r, f), getattr(r_auto, f))


def test_ladder_config_errors():
    A, b = family(26, B=2, n=8)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    with pytest.raises(ValueError, match="config"):
        solve_batched_mixed(At, bt)
    cfg = config_from_jax(JaxBBPGDfConfig(tol=1e-6, max_matvecs=51))
    with pytest.raises(ValueError, match="< 4"):
        solve_batched_mixed(At, bt, config=cfg, phase_a_budget=48)


def test_prepare_dense_batch_matches_jax():
    A, _ = family(27, B=3, n=8)
    At = torch.from_numpy(A).mT          # not contiguous
    out, low = prepare_dense_batch(At, torch.bfloat16)
    assert out.is_contiguous() and low.is_contiguous() and low.dtype == torch.bfloat16
    assert torch.equal(out, At)
    _, jlow = jax_prepare_dense_batch(jnp.asarray(At.numpy()), jnp.bfloat16, donate=False)
    np.testing.assert_array_equal(low.float().numpy(), np.asarray(jlow, np.float32))
    assert prepare_dense_batch(At).is_contiguous()


def test_configs_carry_over_field_for_field():
    jcfg = JaxPCGConfig(tol=3e-7, max_matvecs=77, refresh_every=9, inner_margin=0.2,
                        refresh_restart=False, segment_drop=0.05)
    cfg = config_from_jax(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


# ------------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cast_dense_on_cuda_is_the_bf16_kernel(cuda):
    """CastDense's matvec is one bf16 launch, within 1e-5 of the plain
    version; an f64 x raises (the kernel takes f32 x, and nothing falls
    back)."""
    A, _ = family(31, B=4, n=1000)
    At = torch.from_numpy(A).to(cuda).to(torch.bfloat16)
    x = torch.randn((4, 1000), generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    before, before16 = gemv.LAUNCHES, gemv.LAUNCHES_BF16
    y = CastDense(At).matvec(x)
    torch.cuda.synchronize()
    assert (gemv.LAUNCHES, gemv.LAUNCHES_BF16) == (before + 1, before16 + 1)
    ref = gemv.batched_gemv_reference(At.double(), x.to(torch.bfloat16).double())
    assert float((y.double() - ref).abs().max() / ref.abs().max()) < 1e-5
    with pytest.raises(TypeError):
        CastDense(At).matvec(x.double())


@pytest.mark.cuda
def test_mixed_prec_dense_on_cuda_counts_each_instance(cuda):
    A, _ = family(32, B=3, n=257)
    op = MixedPrecDense.from_f32(torch.from_numpy(A).to(cuda))
    x = torch.ones((3, 257), device=cuda)
    before, before16 = gemv.LAUNCHES, gemv.LAUNCHES_BF16
    op.matvec(x)
    op.matvec_exact(x)
    assert (gemv.LAUNCHES - before, gemv.LAUNCHES_BF16 - before16) == (2, 1)


@pytest.mark.cuda
def test_ladder_on_cuda_matches_cpu_f64(cuda):
    """The ladder on the card (bf16 and f32 kernels) against the port on the
    CPU in f64: every lane converged, solutions within 6 tol."""
    torch.backends.cuda.matmul.allow_tf32 = False
    A, b = family(33, B=16, n=256, scale=0.8)
    tol = 2e-5
    cfg = SOLVERS["bbpgd_f"][1](tol=tol, max_matvecs=500)
    proj64 = proj_from_jax(jax_box(256))
    r64 = solve_batched_mixed(torch.from_numpy(A), torch.from_numpy(b), proj=proj64,
                              config=cfg)
    proj32 = proj_from_jax(JP.box(-np.ones(256), np.ones(256), dtype=jnp.float32)).to(cuda)
    r32 = solve_batched_mixed(torch.from_numpy(A).to(cuda), torch.from_numpy(b).float().to(cuda),
                              proj=proj32, config=cfg)
    assert bool(r32.converged.all()) and bool(r64.converged.all())
    np.testing.assert_allclose(r32.x.cpu().numpy(), r64.x.numpy(), rtol=0, atol=6 * tol)
