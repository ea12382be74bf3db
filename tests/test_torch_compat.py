"""The drop-in class API (``compat``): every case of tests/test_compat.py
through both packages, in f64 on the CPU, and the port's own rules (the
device, the kernels' build outside the clock)."""
import time

import numpy as np
import pytest
import torch

from ccqppy_tpu import compat as jcompat
from ccqppy_tpu_torch import compat

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture
def f64():
    """The port's compat in f64, as the JAX layer under x64 (conftest)."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def _tridiag():
    A = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]])
    x_exact = np.array([1.0, 0.0, 1.0])
    return A, -A @ x_exact, x_exact


# (class name, positional arguments) of tests/test_compat.py's solvers.
SOLVERS = [("CCQPSolverPGD", (1e-8, 10000, 0.1)), ("CCQPSolverAPGD", (1e-8, 10000)),
           ("CCQPSolverAPGDAntiRelaxation", (1e-8, 10000)), ("CCQPSolverBBPGD", (1e-8, 10000)),
           ("CCQPSolverBBPGDf", (1e-8, 10000)), ("CCQPSolverSPG", (1e-8, 10000)),
           ("CCQPSolverMPRGP", (1e-8, 10000)), ("CCQPSolverMPRGPBB", (1e-8, 10000))]
NAMES = {"CCQPSolverPGD": "PGD", "CCQPSolverAPGD": "APGD",
         "CCQPSolverAPGDAntiRelaxation": "Anti-relaxation APGD", "CCQPSolverBBPGD": "BBPGD",
         "CCQPSolverBBPGDf": "BBPGDf", "CCQPSolverSPG": "SPG-QP", "CCQPSolverMPRGP": "MPRGP",
         "CCQPSolverMPRGPBB": "MPGP-BB"}


def _cases(module, **device):
    return [module.IdentityProjOp(3, **device),
            module.BoxProjOp(3, np.zeros(3), 2 * np.ones(3), **device),
            module.DisjointProjOp(*(module.IdentityProjOp(1, **device) for _ in range(3)))]


def test_identity_proj_op(f64):
    x = np.random.default_rng(0).uniform(-5, 5, 10)
    op, jop = compat.IdentityProjOp(10, **CPU), jcompat.IdentityProjOp(10)
    np.testing.assert_array_equal(op(x), np.asarray(jop(x)))
    np.testing.assert_allclose(op(x), x)
    assert op.embedded_dimension == jop.embedded_dimension == 10
    assert op.name == jop.name == "Identity"


@pytest.mark.parametrize("cls,args", SOLVERS, ids=[c for c, _ in SOLVERS])
def test_solvers_against_simple_problems(f64, cls, args):
    """Reference TestSolversAgainstSimpleProblems through both packages:
    each solver converges to x* on the three sets; the deterministic ones
    match the JAX layer's solution to 1e-10 with equal matvec counts.  SPG
    draws from another stream (the port's keys), so it is held to x* and
    its guarantee only."""
    A, b, x_exact = _tridiag()
    for proj, jproj in zip(_cases(compat, **CPU), _cases(jcompat)):
        solver, jsolver = getattr(compat, cls)(*args, **CPU), getattr(jcompat, cls)(*args)
        out = solver.solve(A, b, convex_proj_op=proj)
        jsolver.solve(A, b, convex_proj_op=jproj)
        assert out is solver and solver.name == jsolver.name == NAMES[cls]
        assert solver.solution_converged and jsolver.solution_converged
        assert solver.solution.shape == (3,) and solver.solution.dtype == np.float64
        np.testing.assert_allclose(solver.solution, x_exact, atol=1e-5)
        assert solver.solution_num_matrix_vector_multiplications < 10000
        assert solver.solution_time >= 0
        assert isinstance(solver.solution_residual, float)
        assert solver.solution_residual < 1e-8
        if cls != "CCQPSolverSPG":
            assert (solver.solution_num_matrix_vector_multiplications
                    == jsolver.solution_num_matrix_vector_multiplications), proj.name
            np.testing.assert_allclose(solver.solution, jsolver.solution, rtol=0, atol=1e-10)
            np.testing.assert_allclose(solver.solution_residual, jsolver.solution_residual,
                                       rtol=0, atol=1e-12)


def test_disjoint_proj_op_heterogeneous(f64):
    ops = [m.DisjointProjOp(m.BoxProjOp(2, -np.ones(2), np.ones(2), **d),
                            m.SphereProjOp(3, 1.0, **d), m.ConeProjOp(3, 1.0, **d))
           for m, d in ((compat, CPU), (jcompat, {}))]
    op, jop = ops
    assert op.embedded_dimension == jop.embedded_dimension == 8
    assert op.name == jop.name == "Disjoint Union"
    x = np.array([2.0, -3.0, 1.0, 1.0, 1.0, 3.0, 0.0, 0.5])
    y = op(x)
    np.testing.assert_allclose(y, np.asarray(jop(x)), rtol=0, atol=1e-15)
    np.testing.assert_allclose(y[:2], [1.0, -1.0])
    assert np.linalg.norm(y[2:5]) <= 1.0 + 1e-9
    assert np.linalg.norm(y[5:7]) <= y[7] + 1e-9
    np.testing.assert_allclose(op.normal_vector(x), np.asarray(jop.normal_vector(x)),
                               rtol=0, atol=1e-15)


def test_projected_gradient_protocol(f64):
    x, g = np.array([0.0, 1.0, 0.0]), np.array([2.0, 1.0, -3.0])
    op = compat.LowerBoundProjOp(3, np.zeros(3), **CPU)
    free, chopped = op.projected_gradient(x, g)
    jfree, jchopped = jcompat.LowerBoundProjOp(3, np.zeros(3)).projected_gradient(x, g)
    np.testing.assert_array_equal(free, np.asarray(jfree))
    np.testing.assert_array_equal(chopped, np.asarray(jchopped))
    np.testing.assert_allclose(free, [0.0, 1.0, 0.0])
    np.testing.assert_allclose(chopped, [0.0, 0.0, -3.0])
    up = compat.UpperBoundProjOp(3, **CPU)
    np.testing.assert_array_equal(up(np.array([2.0, 0.5, -4.0])), [1.0, 0.5, -4.0])


def test_spg_seedable(f64):
    A, b, x_exact = _tridiag()
    s1 = compat.CCQPSolverSPG(1e-8, 10000, spg_key=5, **CPU).solve(A, b)
    s2 = compat.CCQPSolverSPG(1e-8, 10000, spg_key=5, **CPU).solve(A, b)
    s3 = compat.CCQPSolverSPG(1e-8, 10000, spg_key=6, **CPU).solve(A, b)
    np.testing.assert_array_equal(s1.solution, s2.solution)
    assert (s1.solution_num_matrix_vector_multiplications
            == s2.solution_num_matrix_vector_multiplications)
    assert s3.solution_converged
    np.testing.assert_allclose(s3.solution, x_exact, atol=1e-5)


def test_plot_smoke(f64):
    """ProjOpBase.plot parity: renders without a display via Agg."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    op = compat.BoxProjOp(3, -np.ones(3), np.ones(3), **CPU)
    ax = op.plot(50, -2 * np.ones(3), 2 * np.ones(3))
    assert ax is not None
    pts = np.asarray(ax.collections[0]._offsets3d)
    assert pts.shape == (3, 50) and np.abs(pts).max() <= 1.0


def test_dtype_resolved_at_call_time(f64):
    """The default dtype set after importing compat is honoured per call."""
    A, b, _ = _tridiag()
    try:
        torch.set_default_dtype(torch.float32)
        s32 = compat.CCQPSolverBBPGD(1e-5, 1000, **CPU).solve(A, b)
        assert s32.solution.dtype == np.float32
        op32 = compat.BoxProjOp(3, **CPU)
        assert op32.core.lb.dtype == torch.float32
    finally:
        torch.set_default_dtype(torch.float64)
    s64 = compat.CCQPSolverBBPGD(1e-10, 1000, **CPU).solve(A, b)
    assert s64.solution.dtype == np.float64
    assert s64.solution_residual < 1e-10


def test_device_mismatch_raises(f64):
    """A set on one device handed to a solver on another raises; it is not
    moved.  So do the parts of a DisjointProjOp on several devices."""
    A, b, _ = _tridiag()
    meta = compat.BoxProjOp(3, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        compat.CCQPSolverBBPGD(1e-8, 100, **CPU).solve(A, b, convex_proj_op=meta)
    assert meta.core.lb.device.type == "meta"
    with pytest.raises(ValueError, match="lies on meta"):
        compat.CCQPSolverBBPGD(1e-8, 100, **CPU).solve(A, b, convex_proj_op=meta.core)
    with pytest.raises(ValueError, match="several devices"):
        compat.DisjointProjOp(compat.IdentityProjOp(1, **CPU), compat.BoxProjOp(2, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        compat.DisjointProjOp(compat.IdentityProjOp(1, **CPU), device="meta")
    # A functional set on the solver's device is taken as it is.
    s = compat.CCQPSolverBBPGD(1e-8, 1000, **CPU).solve(
        A, b, convex_proj_op=compat.BoxProjOp(3, np.zeros(3), 2 * np.ones(3), **CPU).core)
    assert s.solution_converged


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for make in (lambda: compat.IdentityProjOp(3), lambda: compat.BoxProjOp(3),
                 lambda: compat.LowerBoundProjOp(3), lambda: compat.UpperBoundProjOp(3),
                 lambda: compat.SphereProjOp(3), lambda: compat.ConeProjOp(3),
                 lambda: compat.CCQPSolverPGD(1e-8), lambda: compat.CCQPSolverSPG(1e-8),
                 lambda: compat.CCQPSolverMPRGPBB(1e-8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_solution_time_excludes_the_kernel_build(f64, monkeypatch):
    """The clock starts after the kernels are ready: a build of 0.3 s (here
    a stand-in for ``kernels.load`` on the CPU) stays out of it."""
    calls = []

    def slow_build(device):
        calls.append(device)
        time.sleep(0.3)

    monkeypatch.setattr(compat, "_ready", slow_build)
    A, b, _ = _tridiag()
    t0 = time.perf_counter()
    s = compat.CCQPSolverBBPGD(1e-8, 1000, **CPU).solve(A, b)
    assert time.perf_counter() - t0 >= 0.3
    assert calls == [torch.device("cpu")] and s.solution_time < 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_oracle_problem_on_cuda(dtype):
    """compat on the card in f32 and f64, through the GEMV kernel's f32 and
    f64 instances, on the README problem."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccqppy_tpu_torch.ops import gemv
    from ccqppy_tpu_torch.utils import problems
    p = problems.readme_problem(dtype, "cpu")
    saved = torch.get_default_dtype()
    before, before64 = gemv.LAUNCHES, gemv.LAUNCHES_F64
    try:
        torch.set_default_dtype(dtype)
        op = compat.BoxProjOp(3, [-2.0, -2.0, -4.0], [2.0, 2.0, 5.0])
        tol = 1e-8 if dtype == torch.float64 else 1e-5
        s = compat.CCQPSolverMPRGP(tol, 10000).solve(p.A[0].numpy(), p.b[0].numpy(),
                                                      convex_proj_op=op)
    finally:
        torch.set_default_dtype(saved)
    assert s.solution_converged and s.solution.dtype == np.dtype(str(dtype)[6:])
    np.testing.assert_allclose(s.solution, p.exact_solution[0].numpy(), atol=1e-4)
    assert gemv.LAUNCHES > before
    assert (gemv.LAUNCHES_F64 > before64) == (dtype == torch.float64)
