"""Port parity: the row-sharded and scenario-sharded solves on gloo ranks.

``ccqppy_tpu_torch.parallel.solve_sharded``, ``solve_sharded_blocksparse``
and ``solve_batched_sharded`` run on 4 CPU processes joined by gloo,
spawned once for the module (``tests/_torch_dist_cases.sharded_cases``).
Every case is held against the JAX package's sharded solve (8 virtual CPU
devices, ``tests/conftest.py``) and the port's unsharded solve, in f64 on
the same numpy problems.  Row sharding changes only the order of the sums
in dots and matvecs, so trajectories agree to rounding.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.ops.linop import BlockSparseOperator as JaxBlockSparse
from ccqppy_tpu.parallel import make_batch_mesh as jax_batch_mesh
from ccqppy_tpu.parallel import make_mesh as jax_mesh
from ccqppy_tpu.parallel import solve_batched as jax_solve_batched
from ccqppy_tpu.parallel import solve_batched_sharded as jax_solve_batched_sharded
from ccqppy_tpu.parallel import solve_sharded as jax_solve_sharded
from ccqppy_tpu.parallel import solve_sharded_blocksparse as jax_solve_sharded_blocksparse
from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.ops.projections import blockwise, box, lorentz_cone
from ccqppy_tpu_torch.parallel import solve_batched
from ccqppy_tpu_torch.parallel.distributed import spawn_ranks
from ccqppy_tpu_torch.utils.rng import split_keys

import _torch_dist_cases as cases

torch.set_num_threads(1)

WORLD = 4
TIMEOUT = 120        # seconds for the ranks' whole run, and for each collective
X_TOL = 1e-9         # |x_port - x_ref|: f64 sums in another order (the JAX tests' bound)
# On cones MPRGP's trajectories agree to ~1e-8 under another sum order (its
# feasible step on the cone surface decides on rounding; 8.3e-9 measured
# between the two packages, ROADMAP queue 3 caveats).
CONE_X_TOL = 1e-8

CONFIGS_A = {"bbpgd": {"tol": 1e-8, "max_matvecs": 5000},
             "mprgp_bb": {"tol": 1e-8, "max_matvecs": 5000},
             "pgd": {"tol": 1e-8, "max_matvecs": 5000, "step_size": 1e-4},
             "apgd_ar": {"tol": 1e-8, "max_matvecs": 5000},
             # No spectral bounds on the operator: the in-solve power
             # iteration runs on the sharded matvec and dot.
             "apgd_sc": {"tol": 1e-8, "max_matvecs": 5000}}
CONFIG_B = {"tol": 1e-9, "max_matvecs": 5000, "precond": "jacobi"}
CONFIG_C = {"tol": 1e-10, "max_matvecs": 5000}
CONFIGS_D = {s: {"tol": 1e-10, "max_matvecs": 5000} for s in ("bbpgd", "mprgp_bb", "pcg")}
CONFIG_E = {"tol": 1e-8, "max_matvecs": 5000}
CONFIG_E_SPG = {"tol": 1e-6, "max_matvecs": 5000}
# Cones at tol 1e-6, where MPRGP's matvec counts under two sum orders still
# agree (ROADMAP queue 3 caveats: equal per-lane counts up to 1e-6 at n=60).
CONFIG_H = {"tol": 1e-6, "max_matvecs": 5000}
SEEDS_C = range(6)


def wishart(rng, n, spread):
    """A = G G^T + n I, x ~ U(-spread, spread), b = -A x."""
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n)
    return A, -A @ rng.uniform(-spread, spread, n)


def problems():
    """Every case's problem, as numpy f64 arrays with a lane axis."""
    a = {}
    # (a) the dense family of test_sharded_huge_qp_matches_single_device.
    A, b = wishart(np.random.default_rng(1), 64, 1.0)
    a["A_a"], a["b_a"] = A[None], b[None]
    # (b) a strongly heterogeneous diagonal, so that Jacobi changes the path
    # (test_sharded_jacobi_pcg_diagonal_contract).
    rng = np.random.default_rng(21)
    d = 10.0 ** rng.uniform(-1.5, 1.5, 64)
    G = rng.standard_normal((64, 64))
    A = G @ G.T + np.eye(64) + np.diag(d) * 64
    a["A_b"], a["b_b"] = A[None], (-A @ rng.uniform(-1, 1, 64))[None]
    # (c) six box QPs whose optima have many active bounds.
    pairs = [wishart(np.random.default_rng(s), 64, 2.0) for s in SEEDS_C]
    a["A_c"] = np.stack([A for A, _ in pairs])
    a["b_c"] = np.stack([b for _, b in pairs])
    # (d) the block-tridiagonal ELL problem of
    # test_sharded_blocksparse_matches_single_device: 16 block rows of 4.
    bs_, nb = 4, 16
    n = bs_ * nb
    rng = np.random.default_rng(11)
    D = rng.standard_normal((n, n)) * 0.1
    A = np.zeros((n, n))
    for i in range(nb):
        for j in range(max(0, i - 1), min(nb, i + 2)):
            A[i * bs_:(i + 1) * bs_, j * bs_:(j + 1) * bs_] = D[i * bs_:(i + 1) * bs_, j * bs_:(j + 1) * bs_]
    A = 0.5 * (A + A.T) + 2.0 * np.eye(n)
    x_exact = rng.uniform(-0.5, 0.5, n)
    jop = JaxBlockSparse.from_scipy_bsr(sp.bsr_matrix(A, blocksize=(bs_, bs_)), dtype=jnp.float64)
    a["blocks_d"] = np.array(jop.blocks)[None]
    a["cols_d"] = np.array(jop.cols).astype(np.int64)[None]
    a["b_d"], a["x_exact_d"] = (-A @ x_exact)[None], x_exact[None]
    # (e) a batch of 8 box QPs, some bounds active; SPG keys of the port.
    rng = np.random.default_rng(5)
    pairs = [wishart(rng, 24, 1.5) for _ in range(8)]
    a["A_e"] = np.stack([A for A, _ in pairs])
    a["b_e"] = np.stack([b for _, b in pairs])
    a["keys_e"] = split_keys(3, 8).numpy()
    # (h) 16 Lorentz-cone blocks of 3, 12 coordinates (4 blocks) a rank.
    A, b = wishart(np.random.default_rng(7), 48, 1.0)
    a["A_h"], a["b_h"] = A[None], b[None]
    # ... and per-block box bounds (child_axes=0), one (3,) pair a block.
    lb = np.random.default_rng(8).uniform(-0.6, -0.1, (16, 3))
    a["lb_h"], a["ub_h"] = lb, lb + 0.7
    return a


@pytest.fixture(scope="module")
def run():
    """The problems, and every rank's results of ``sharded_cases``."""
    arrays = problems()
    params = {"arrays": {k: v for k, v in arrays.items() if k != "x_exact_d"},
              "configs_a": CONFIGS_A, "config_b": CONFIG_B, "config_c": CONFIG_C,
              "configs_d": CONFIGS_D, "config_e": CONFIG_E, "config_e_spg": CONFIG_E_SPG,
              "config_h": CONFIG_H}
    return arrays, spawn_ranks(cases.sharded_cases, WORLD, params, device="cpu",
                               timeout=TIMEOUT)


def joined(outs, key, axis=-1):
    """The ranks' results of one case: x joined over the ranks along
    ``axis``, the shared fields checked equal on every rank."""
    rs = [o[key] for o in outs]
    if axis == -1:
        for f in ("residual", "converged", "matvecs", "iterations"):
            for r in rs[1:]:
                np.testing.assert_array_equal(r[f], rs[0][f], err_msg=f"{key} {f} differs by rank")
        return {**rs[0], "x": np.concatenate([r["x"] for r in rs], axis=-1)}
    return {f: np.concatenate([r[f] for r in rs], axis=0) for f in rs[0] if f != "collectives"}


def port_unsharded(solver, A, b, kwargs, proj=None):
    n = b.shape[-1]
    proj = proj if proj is not None else box(-torch.ones(n), torch.ones(n), dtype=torch.float64)
    return SOLVERS[solver][0](torch.from_numpy(A), torch.from_numpy(b), proj=proj,
                              config=SOLVERS[solver][1](**kwargs))


def jax_box(n):
    return cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64), jnp.float64)


def jax_sharded(solver, A, b, kwargs):
    n = b.shape[-1]
    return jax_solve_sharded(solver, jnp.asarray(A[0]), jnp.asarray(b[0]), jax_mesh(axis="model"),
                             proj=jax_box(n), config=cq.models.SOLVERS[solver][1](**kwargs))


@pytest.mark.parametrize("solver", sorted(CONFIGS_A))
def test_sharded_dense_matches_jax_and_unsharded(run, solver):
    """(a) x within X_TOL of JAX's sharded solve and of the port's unsharded
    one; matvecs within 1 (APGD-AR: within 2x, as the JAX test allows: its
    backtracking decides on rounding); the same ``converged``; an
    all-gather for every matvec and summed dots."""
    arrays, outs = run
    r = joined(outs, ("a", solver))
    A, b = arrays["A_a"], arrays["b_a"]
    rj = jax_sharded(solver, A, b, CONFIGS_A[solver])
    rp = port_unsharded(solver, A, b, CONFIGS_A[solver])
    assert bool(r["converged"][0]) == bool(rj.converged) == bool(rp.converged[0]) is True
    np.testing.assert_allclose(r["x"][0], np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(r["x"], rp.x.numpy(), rtol=0, atol=X_TOL)
    mv, mvj, mvp = int(r["matvecs"][0]), int(rj.matvecs), int(rp.matvecs[0])
    if solver == "apgd_ar":
        assert mv <= 2 * mvj and mv <= 2 * mvp
    else:
        assert abs(mv - mvj) <= 1 and abs(mv - mvp) <= 1
    counts = outs[0]["a", solver]["collectives"]
    assert counts["all_gather"] >= mv and counts["all_reduce_sum"] >= int(r["iterations"][0])


def test_sharded_jacobi_pcg_diagonal_contract(run):
    """(b) each rank's ``diagonal()`` is its rows of diag(A), exactly; the
    Jacobi-preconditioned sharded solve matches JAX's sharded and the
    port's unsharded one (x within X_TOL, matvecs within 1) and is
    cheaper than the unpreconditioned solve."""
    arrays, outs = run
    A, b = arrays["A_b"], arrays["b_b"]
    diag = np.concatenate([o["b_diag"] for o in outs], axis=-1)
    np.testing.assert_array_equal(diag[0], np.diag(A[0]))
    r = joined(outs, "b")
    rj = jax_sharded("pcg", A, b, CONFIG_B)
    rp = port_unsharded("pcg", A, b, CONFIG_B)
    assert bool(r["converged"][0]) and bool(rj.converged) and bool(rp.converged[0])
    np.testing.assert_allclose(r["x"][0], np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(r["x"], rp.x.numpy(), rtol=0, atol=X_TOL)
    assert abs(int(r["matvecs"][0]) - int(rj.matvecs)) <= 1
    assert abs(int(r["matvecs"][0]) - int(rp.matvecs[0])) <= 1
    plain = port_unsharded("pcg", A, b, {"tol": 1e-9, "max_matvecs": 5000})
    assert int(rp.matvecs[0]) < int(plain.matvecs[0])


@pytest.mark.parametrize("seed", list(SEEDS_C))
def test_sharded_pcg_active_set_counts(run, seed):
    """(c) PCG on box QPs with x_uncon ~ U(-2, 2), many bounds active at
    the optimum: the restart test on the per-shard mask change keeps JAX's
    semantics, and the matvec count equals JAX's sharded and the port's
    unsharded count exactly; x within X_TOL; the active set is the same."""
    arrays, outs = run
    A, b = arrays["A_c"][seed:seed + 1], arrays["b_c"][seed:seed + 1]
    r = joined(outs, ("c", seed))
    rj = jax_sharded("pcg", A, b, CONFIG_C)
    rp = port_unsharded("pcg", A, b, CONFIG_C)
    assert bool(r["converged"][0]) and bool(rj.converged) and bool(rp.converged[0])
    assert int(r["matvecs"][0]) == int(rj.matvecs) == int(rp.matvecs[0])
    np.testing.assert_allclose(r["x"][0], np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(r["x"], rp.x.numpy(), rtol=0, atol=X_TOL)
    active = np.abs(r["x"][0]) == 1.0
    assert active.sum() >= 10
    np.testing.assert_array_equal(active, np.abs(np.asarray(rj.x)) == 1.0)


@pytest.mark.parametrize("solver", sorted(CONFIGS_D))
def test_sharded_blocksparse_matches_jax_and_unsharded(run, solver):
    """(d) 16 block rows over 4 ranks: x within X_TOL of JAX's sharded and
    the port's unsharded block-sparse solve and within 1e-6 of the
    unconstrained optimum (interior); matvecs within 2."""
    from ccqppy_tpu_torch.ops.linop import BlockSparseOperator
    arrays, outs = run
    r = joined(outs, ("d", solver))
    kwargs = CONFIGS_D[solver]
    blocks, cols, b = arrays["blocks_d"], arrays["cols_d"], arrays["b_d"]
    n = b.shape[-1]
    rj = jax_solve_sharded_blocksparse(solver, jnp.asarray(blocks[0]),
                                       jnp.asarray(cols[0], jnp.int32), jnp.asarray(b[0]),
                                       jax_mesh(), proj=jax_box(n),
                                       config=cq.models.SOLVERS[solver][1](**kwargs))
    op = BlockSparseOperator(torch.from_numpy(blocks), torch.from_numpy(cols))
    rp = SOLVERS[solver][0](op, torch.from_numpy(b),
                            proj=box(-torch.ones(n), torch.ones(n), dtype=torch.float64),
                            config=SOLVERS[solver][1](**kwargs))
    assert bool(r["converged"][0]) and bool(rj.converged) and bool(rp.converged[0])
    np.testing.assert_allclose(r["x"][0], np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(r["x"], rp.x.numpy(), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(r["x"], arrays["x_exact_d"], rtol=0, atol=1e-6)
    assert abs(int(r["matvecs"][0]) - int(rj.matvecs)) <= 2
    assert abs(int(r["matvecs"][0]) - int(rp.matvecs[0])) <= 2


def test_batched_sharded_bbpgd_matches_jax_and_unsharded(run):
    """(e) 8 lanes over 4 ranks, 2 each: every lane bitwise the port's
    ``solve_batched`` lane with the same matvecs (lanes do not see each
    other); within X_TOL of JAX's ``solve_batched_sharded`` (8 devices)
    with the same matvecs; no collective in the solve."""
    arrays, outs = run
    r = joined(outs, ("e", "bbpgd"), axis=0)
    A, b = arrays["A_e"], arrays["b_e"]
    rp = port_unsharded("bbpgd", A, b, CONFIG_E)
    rj = jax_solve_batched_sharded("bbpgd", jnp.asarray(A), jnp.asarray(b), jax_batch_mesh(),
                                   proj=jax_box(b.shape[-1]),
                                   config=cq.models.BBPGDConfig(**CONFIG_E))
    assert r["converged"].all() and bool(rp.converged.all()) and bool(jnp.all(rj.converged))
    np.testing.assert_array_equal(r["x"], rp.x.numpy())
    np.testing.assert_array_equal(r["matvecs"], rp.matvecs.numpy())
    np.testing.assert_allclose(r["x"], np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_array_equal(r["matvecs"], np.asarray(rj.matvecs))
    assert all(not any(o["e", "bbpgd"]["collectives"].values()) for o in outs)


def test_batched_sharded_spg_keys(run):
    """(e) SPG with per-lane keys through ``solve_batched_sharded``: each
    rank takes its lanes' keys, so every lane is bitwise the port's
    ``solve_batched`` lane on the same keys, and no collective runs.  (The
    port's keys are not JAX's threefry stream, so JAX's SPG takes other
    steps: against it, convergence of every lane only.)"""
    arrays, outs = run
    r = joined(outs, ("e", "spg"), axis=0)
    A, b = arrays["A_e"], arrays["b_e"]
    n = b.shape[-1]
    rp = solve_batched("spg", torch.from_numpy(A), torch.from_numpy(b),
                       proj=box(-torch.ones(n), torch.ones(n), dtype=torch.float64),
                       config=SOLVERS["spg"][1](**CONFIG_E_SPG),
                       keys=torch.from_numpy(arrays["keys_e"]))
    np.testing.assert_array_equal(r["x"], rp.x.numpy())
    np.testing.assert_array_equal(r["matvecs"], rp.matvecs.numpy())
    assert r["converged"].all()
    rj = jax_solve_batched("spg", jnp.asarray(A), jnp.asarray(b), proj=jax_box(n),
                           config=cq.models.SPGConfig(**CONFIG_E_SPG),
                           keys=jax.random.split(jax.random.PRNGKey(3), A.shape[0]))
    assert bool(jnp.all(rj.converged))
    assert all(not any(o["e", "spg"]["collectives"].values()) for o in outs)


def test_coupling_sets_raise_aligned_blocks_solve(run):
    """(h) a ball couples every coordinate and a cone block of 3 crosses a
    16-row shard: both raise, naming the constraint; coordinate-sized
    bounds with ``proj_sharded=False`` raise, scalar ones solve as (c)'s
    sliced bounds do (x within X_TOL, the same matvecs).  Blocks of 3
    aligned with 12-row shards: per-block box bounds (``child_axes=0``, cut
    to the rank's blocks) solve as the port's unsharded PCG does (x within
    X_TOL, the same matvecs, bounds active); Lorentz cones as its unsharded
    MPRGP-BB does (x within CONE_X_TOL, matvecs within 1)."""
    arrays, outs = run
    for o in outs:
        assert "couples coordinates across shards" in o["h", "ball"]
        assert "cross the shard boundaries" in o["h", "cone_across"]
        assert "proj_sharded=False" in o["h", "shared_bounds"]
    shared, sliced = joined(outs, ("h", "scalar_bounds")), joined(outs, ("c", 0))
    np.testing.assert_allclose(shared["x"], sliced["x"], rtol=0, atol=X_TOL)
    np.testing.assert_array_equal(shared["matvecs"], sliced["matvecs"])
    r = joined(outs, ("h", "per_block_bounds"))
    per_block = blockwise(box(torch.from_numpy(arrays["lb_h"]), torch.from_numpy(arrays["ub_h"]),
                              dtype=torch.float64), 3, child_axes=0)
    rp = port_unsharded("pcg", arrays["A_h"], arrays["b_h"], CONFIG_C, proj=per_block)
    assert bool(r["converged"][0]) and bool(rp.converged[0])
    np.testing.assert_allclose(r["x"], rp.x.numpy(), rtol=0, atol=X_TOL)
    assert int(r["matvecs"][0]) == int(rp.matvecs[0])
    assert (np.isclose(r["x"], arrays["lb_h"].reshape(1, -1)) |
            np.isclose(r["x"], arrays["ub_h"].reshape(1, -1))).sum() >= 5
    r = joined(outs, ("h", "cone_aligned"))
    cone = blockwise(lorentz_cone(1.0, dtype=torch.float64), 3)
    rp = port_unsharded("mprgp_bb", arrays["A_h"], arrays["b_h"], CONFIG_H, proj=cone)
    assert bool(r["converged"][0]) and bool(rp.converged[0])
    np.testing.assert_allclose(r["x"], rp.x.numpy(), rtol=0, atol=CONE_X_TOL)
    assert abs(int(r["matvecs"][0]) - int(rp.matvecs[0])) <= 1
