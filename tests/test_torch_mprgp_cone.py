"""MPRGP-BB on Lorentz-block problems: the port against the benchmark's plain
reference (``qpbench/reference/solve.py``), the f64 audit of its claims
below f64, and its iteration counter and span.

The problems are cone999's family at small n: ``A = G G^T + n I``, ``b =
-A x_u + 1e-3 N(0, 1)``, ``x_u ~ U(-1, 1)``, made in f64 and rounded to the
solve's dtype; the set is ``blockwise(lorentz_cone(1), 3)``.  Every residual
the tests judge is the check's: Eq. 25 in closed form, worked out in f64
from the stack and b the solver was given (``qpbench/reference/sets.py``).
"""
import pytest
import torch

from ccqppy_tpu_torch.models import base, mprgp
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import DenseOperator
from ccqppy_tpu_torch.ops.projections import blockwise, lorentz_cone
from ccqppy_tpu_torch.parallel import batch
from qpbench.reference import sets
from qpbench.reference import solve as reference

torch.set_num_threads(1)

SPEC = {"kind": "lorentz_blocks", "block_dim": 3, "mu": 1.0}
GD = 1e-6
REF_TOL = 1e-10


def problem(n, B, seed, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    G = torch.randn((B, n, n), generator=g, dtype=torch.float64)
    A = G @ G.mT + n * torch.eye(n, dtype=torch.float64)
    xu = 2 * torch.rand((B, n), generator=g, dtype=torch.float64) - 1
    b = -(A @ xu[..., None])[..., 0] + 1e-3 * torch.randn((B, n), generator=g, dtype=torch.float64)
    return A.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype)


def cone(dtype, device="cpu"):
    return blockwise(lorentz_cone(1.0, dtype=dtype, device=device), 3)


def solve(A, b, tol, fused=True, budget=2000):
    """``solve_batched("mprgp_bb")`` on A (a stack or an operator) from the
    cone-Jacobi start, as the benchmark's cell calls it."""
    op = A if isinstance(A, DenseOperator) else DenseOperator(A)
    proj = cone(b.dtype, b.device)
    x0 = proj.project(-b / op.diagonal())
    cfg = MPRGPBBConfig(tol=tol, max_matvecs=budget, fused=fused)
    return batch.solve_batched("mprgp_bb", op, b, x0=x0, proj=proj, config=cfg)


def audit(A, b, x):
    """The check's residual of each lane's x, in f64 from A and b."""
    A64, b64, x64 = A.double(), b.double(), x.double()
    return sets.pg_residual(SPEC, x64, reference.bmv(A64, x64) + b64, GD)


CASES = [(99, torch.float64, 1e-8), (99, torch.float32, 1e-5),
         (999, torch.float64, 1e-8), (999, torch.float32, 1e-5)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("n,dtype,tol", CASES,
                         ids=[f"n{n}-{str(d)[-7:]}" for n, d, _ in CASES])
def test_matches_the_plain_reference(n, dtype, tol, fused):
    """Every lane converges, audits under tol, and lies within 6 tol of the
    reference optimum.  Why 6 tol: A >= n I makes the QP n-strongly convex,
    and the Eq. 25 vector is the gradient plus a normal of the set at x, so
    ``||x - x*|| <= ||r|| / n = 3 res`` for the answer (res < tol) and for
    the reference (res <= 1e-10); twice that bound leaves room for the
    surface band's tolerance."""
    A, b = problem(n, 4, seed=n, dtype=dtype)
    r = solve(A, b, tol, fused=fused)
    assert bool(r.converged.all())
    assert float(audit(A, b, r.x).max()) < tol
    x_ref, res_ref, _ = reference.solve(A.double(), b.double(), SPEC, GD, tol=REF_TOL)
    assert float(res_ref.max()) <= REF_TOL
    gap = torch.linalg.vector_norm(r.x.double() - x_ref, dim=-1)
    assert float(gap.max()) <= 6 * (tol + REF_TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_no_f32_lane_is_reported_converged_above_tol(fused):
    """The smallest f32 case found where claims on f32 sums under-read: n =
    30, B = 8, seed 0, tol 5e-7, where a loop that stops on a residual from
    f32 sums reports 6 of 8 lanes converged at 5.11-5.53e-7 (the sums carry
    the rounding of ``|A x|``, a tenth of tol here).  Every lane converges,
    and every reported-converged lane's check residual is under tol."""
    tol = 5e-7
    A, b = problem(30, 8, seed=0, dtype=torch.float32)
    r = solve(A, b, tol, fused=fused)
    assert bool(r.converged.all())
    res = audit(A, b, r.x)
    assert float(res.max()) < tol
    # The reported residual is the audited one, rounded to f32.
    torch.testing.assert_close(r.residual.double(), res, rtol=1e-6, atol=0)


def _claimed_state(A, b, tol):
    """A fused state of three done lanes whose f32 residual reads under tol:
    x at the f64 optimum (audits under tol), x a step away from it (audits
    over tol) and a lane at its budget."""
    x_ref, _, _ = reference.solve(A.double(), b.double(), SPEC, GD, tol=REF_TOL)
    x = x_ref.float()
    x[1] = cone(torch.float64).project(x_ref[1:2] + 1e-4)[0].float()
    B = b.shape[0]
    z = torch.zeros_like(b)
    false = torch.zeros(B, dtype=torch.bool)
    return mprgp._FusedState(
        x=x, g=z, p=z, x_prev=x, g_prev=z, alpha_bb=torch.ones(B), pending=false,
        verifying=false, res=torch.full((B,), tol / 2), mv=torch.tensor([10, 10, 40]),
        it=torch.tensor([5, 5, 20]), done=torch.ones(B, dtype=torch.bool),
        trace=torch.zeros((B, 0)))


def test_the_audit_decides_each_claim():
    """``_audit_fused`` on a hand-made state: the lane whose x audits under
    tol stays done with the audited residual and one more matvec; the lane
    whose x does not is resumed with the f64 gradient and its free part,
    one more matvec; the lane at its budget is not charged.  A second audit
    charges none of them again: the first lane has passed, the budget lane
    has no matvec left, and the resumed lane is not done."""
    tol, budget = 1e-5, 40
    A, b = problem(30, 3, seed=2, dtype=torch.float32)
    s = _claimed_state(A, b, tol)
    op, proj = DenseOperator(A), cone(torch.float32)
    cfg = MPRGPBBConfig(tol=tol, max_matvecs=budget)
    before = mprgp.MPRGP_AUDITS
    t, resumed, passed = mprgp._audit_fused(op, proj, mprgp._f64_set(proj), b, s, cfg,
                                            torch.zeros(3, dtype=torch.bool))
    assert mprgp.MPRGP_AUDITS == before + 1
    res = audit(A, b, s.x)
    assert float(res[0]) < tol < float(res[1])
    assert resumed.tolist() == [False, True, False] and passed.tolist() == [True, False, False]
    assert t.done.tolist() == [True, False, True] and t.mv.tolist() == [11, 11, 40]
    torch.testing.assert_close(t.res[:2].double(), res[:2], rtol=1e-6, atol=0)
    assert torch.equal(t.res[2], s.res[2])
    g = (A.double() @ s.x.double()[..., None])[..., 0] + b.double()
    torch.testing.assert_close(t.g[1], g[1].float(), rtol=0, atol=0)
    torch.testing.assert_close(t.p[1], proj.free_chopped(s.x, t.g)[0][1], rtol=0, atol=0)
    assert torch.equal(t.g[[0, 2]], s.g[[0, 2]]) and torch.equal(t.x, s.x)
    u, _, passed2 = mprgp._audit_fused(op, proj, mprgp._f64_set(proj), b, t, cfg, passed)
    assert u.mv.tolist() == [11, 11, 40] and passed2.tolist() == [True, False, False]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_every_sweep_is_counted(fused):
    """At B = 1 every sweep of an f32 solve is in its matvecs: the fused form
    takes two at the start, one a pass of its loop and one an audit; the
    unfused form's count is the JAX package's (its verification sweep is
    the audit).  In f64 no audit runs."""
    A, b = problem(99, 1, seed=4, dtype=torch.float32)
    it0, au0 = mprgp.MPRGP_ITERS, mprgp.MPRGP_AUDITS
    r = solve(A, b, 1e-5, fused=fused)
    iters, audits = mprgp.MPRGP_ITERS - it0, mprgp.MPRGP_AUDITS - au0
    assert bool(r.converged[0]) and audits >= 1
    if fused:
        assert int(r.matvecs[0]) == 2 + iters + audits
    au0 = mprgp.MPRGP_AUDITS
    solve(A.double(), b.double(), 1e-8, fused=fused)
    assert mprgp.MPRGP_AUDITS == au0


class CountingExact(DenseOperator):
    """A dense operator that counts its exact matvecs: in an f64 solve of the
    unfused form, its verification sweeps."""

    def __init__(self, A):
        super().__init__(A)
        self.exact = 0

    def matvec_exact(self, x):
        self.exact += 1
        return super().matvec_exact(x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_iteration_counter_and_span(fused, dtype):
    """``MPRGP_ITERS`` counts the loop's passes: at B = 1 the lane's
    iterations.  ``HOST_SYNCS`` is one flag a pass plus what the loops end
    on: fused, one a round of the loop and, below f64, one for each audit's
    flag; unfused, two a verification (its inner loop's last flag and its
    outer loop's) and the outer loop's last.  Under a profiler the answers
    and the counts are the same, and each pass is one
    ``ccqppy.mprgp.iter`` span."""
    tol = 1e-8 if dtype == torch.float64 else 1e-5
    A, b = problem(60, 1, seed=6, dtype=dtype)
    f32 = dtype == torch.float32

    def counted():
        op = CountingExact(A)
        c0 = (mprgp.MPRGP_ITERS, mprgp.MPRGP_AUDITS, base.HOST_SYNCS)
        r = solve(op, b, tol, fused=fused)
        return r, op.exact, [c - c_0 for c, c_0 in zip(
            (mprgp.MPRGP_ITERS, mprgp.MPRGP_AUDITS, base.HOST_SYNCS), c0)]

    r, exact, (iters, audits, syncs) = counted()
    assert iters == int(r.iterations[0]) > 0
    if fused:
        assert syncs == iters + (2 * audits if f32 else 1)
    else:
        assert syncs == iters + 2 * (audits if f32 else exact) + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r2, _, counts2 = counted()
    assert counts2 == [iters, audits, syncs]
    assert torch.equal(r2.x, r.x) and torch.equal(r2.matvecs, r.matvecs)
    assert sum(e.name == "ccqppy.mprgp.iter" for e in prof.events()) == iters


def counters():
    """The GEMV's launch counters by instance and its lanes swept, the host
    syncs and the loop's passes."""
    return (gemv.LAUNCHES, gemv.LAUNCHES_BF16, gemv.LAUNCHES_F64, gemv.LAUNCHES_F32_F64,
            gemv.LANES_SWEPT, base.HOST_SYNCS, mprgp.MPRGP_ITERS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_graph_replays_are_the_eager_loop_on_the_card(cuda, dtype, monkeypatch):
    """On the card the fused loop replays a CUDA graph of a pass after its
    first.  With the eager body (the step kernel's is held to it in
    ``test_torch_mprgp_step``), the answers, residuals, matvecs and
    iterations are bitwise the eager loop's, and so are the counters: the
    GEMV launches by instance and the lanes swept, the host syncs and the
    loop's passes."""
    tol = 1e-5 if dtype == torch.float32 else 1e-8
    A, b = problem(999, 8, seed=7, dtype=dtype, device=cuda)
    monkeypatch.setattr(mprgp, "_step_args", lambda *args: None)

    def run():
        c0 = counters()
        r = solve(A, b, tol)
        torch.cuda.synchronize()
        return r, [c - c_0 for c, c_0 in zip(counters(), c0)]

    graphed, counts = run()
    monkeypatch.setattr(mprgp, "_graphed", lambda op, b: False)
    eager, eager_counts = run()
    assert bool(graphed.converged.all()) and counts == eager_counts and counts[-1] > 2
    for name in ("x", "residual", "matvecs", "iterations", "converged"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name)), name


@pytest.mark.cuda
def test_n9999_on_the_card(cuda):
    """BASELINE #3's problem at B = 1 (n = 9999, 3,333 cones, tol 1e-5, the
    GEMV kernel's f32 stack): the lane converges and audits under tol in
    f64 from A and b, as the benchmark's check does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, tol = 9999, 1e-5
    g = torch.Generator(device=cuda).manual_seed(9999)
    G = torch.randn((1, n, n), generator=g, device=cuda)
    A = torch.bmm(G, G.mT)
    del G
    A.diagonal(dim1=-2, dim2=-1).add_(n)
    xu = 2 * torch.rand((1, n), generator=g, device=cuda) - 1
    b = -torch.bmm(A, xu[..., None])[..., 0]
    r = solve(A, b, tol, budget=20_000)
    assert bool(r.converged[0])
    assert float(audit(A, b, r.x)[0]) < tol
