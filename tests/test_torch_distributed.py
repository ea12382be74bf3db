"""Port parity: process groups, the 2-D grid and the dry run on gloo ranks.

``ccqppy_tpu_torch.parallel.distributed`` (``init_distributed``,
``make_hybrid_mesh``, ``scaling_probe``, ``spawn_ranks``) and
``ccqppy_tpu_torch.entry`` on CPU processes joined by gloo, the
counterpart of ``tests/test_distributed.py`` and ``tests/_dist_worker.py``.
The ranks are spawned once for the module
(``tests/_torch_dist_cases.distributed_cases``); every wait has a timeout.
Results are held against the JAX package in f64 on the same numpy
problems.
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccqppy_tpu as cq
from ccqppy_tpu.parallel import make_mesh as jax_mesh
from ccqppy_tpu.parallel import solve_batched as jax_solve_batched
from ccqppy_tpu.parallel import solve_sharded as jax_solve_sharded
from ccqppy_tpu_torch.entry import dryrun_multichip, entry, grid, main
from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel.distributed import init_distributed, spawn_ranks

import _torch_dist_cases as cases

torch.set_num_threads(1)

WORLD = 4
TIMEOUT = 120        # seconds for the ranks' whole run, and for each collective
X_TOL = 1e-9         # |x_port - x_ref|: f64 sums in another order (the JAX tests' bound)
CONFIG_DP = {"tol": 1e-8, "max_matvecs": 2000}
CONFIG_TP = {"tol": 1e-8, "max_matvecs": 2000}


def problems():
    """The problems of ``tests/_dist_worker.py`` on a (2, 2) grid, as numpy
    f64: the dp leg's 4 box QPs of n = 16 and the tp leg's one of 64."""
    B, n = 4, 16
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, n, n))
    As = G @ np.transpose(G, (0, 2, 1)) + n * np.eye(n)
    bs = -np.einsum("bij,bj->bi", As, rng.uniform(-1, 1, (B, n)))
    n_big = 64
    G1 = np.random.default_rng(1).standard_normal((n_big, n_big))
    A1 = G1 @ G1.T + n_big * np.eye(n_big)
    x_exact = np.random.default_rng(2).uniform(-0.5, 0.5, n_big)
    return {"A_dp": As, "b_dp": bs, "A_tp": A1[None], "b_tp": (-A1 @ x_exact)[None],
            "x_exact_tp": x_exact[None]}


@pytest.fixture(scope="module")
def run():
    """The problems, and every rank's results of ``distributed_cases``."""
    arrays = problems()
    params = {"arrays": {k: v for k, v in arrays.items() if k != "x_exact_tp"},
              "config_dp": CONFIG_DP, "config_tp": CONFIG_TP}
    return arrays, spawn_ranks(cases.distributed_cases, WORLD, params, device="cpu",
                               timeout=TIMEOUT)


def jax_box(n):
    return cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64), jnp.float64)


def test_init_distributed_is_idempotent(run):
    """(i) a second ``init_distributed`` on a joined rank returns its (rank,
    world) and keeps the group; one that asks for another backend raises."""
    _, outs = run
    assert [o["init"] for o in outs] == [(r, WORLD) for r in range(WORLD)]
    assert all("runs gloo, not the nccl" in o["init_other_backend"] for o in outs)


def test_hybrid_mesh_shapes(run):
    """The (batch, model) grid of ``ici_size=2``: rank r at (r // 2, r % 2);
    ``ici_size=3`` does not divide 4 ranks and raises; with no host size in
    the environment every rank is on the inner axis."""
    _, outs = run
    assert all(o["mesh"] == {"batch": 2, "model": 2} for o in outs)
    assert [o["coordinate"] for o in outs] == [[r // 2, r % 2] for r in range(WORLD)]
    assert all("ici_size=3 must divide 4 ranks" in o["ici_3"] for o in outs)
    assert all(o["default_mesh"] == {"batch": 1, "model": 4} for o in outs)


def test_hybrid_grid_dp_leg(run):
    """(f) scenario batching over ``batch``: the two ranks of a batch group
    solve the same 2 lanes, the groups split the 4; every lane within
    X_TOL of JAX's batched solve with the same matvecs; no collective."""
    arrays, outs = run
    by_group = {}
    for o in outs:
        b_i, m_i = o["coordinate"]
        if m_i == 0:
            by_group[b_i] = o["dp"]
        else:
            np.testing.assert_array_equal(o["dp"]["x"], outs[2 * b_i]["dp"]["x"])
    x = np.concatenate([by_group[0]["x"], by_group[1]["x"]])
    mv = np.concatenate([by_group[0]["matvecs"], by_group[1]["matvecs"]])
    rj = jax_solve_batched("bbpgd", jnp.asarray(arrays["A_dp"]), jnp.asarray(arrays["b_dp"]),
                           proj=jax_box(16), config=cq.models.BBPGDConfig(**CONFIG_DP))
    assert bool(jnp.all(rj.converged)) and all(o["dp"]["converged"].all() for o in outs)
    np.testing.assert_allclose(x, np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_array_equal(mv, np.asarray(rj.matvecs))
    assert all(not any(o["dp"]["collectives"].values()) for o in outs)


def test_hybrid_grid_tp_leg(run):
    """(f) one QP row-sharded over ``model`` (2 ranks, 32 rows each), the
    same in both batch groups: x within X_TOL of JAX's sharded solve (8
    devices) and of the port's unsharded MPRGP-BB, matvecs within 1, and
    within 1e-5 of the interior optimum; the collectives stay inside the
    model group (an all-gather per matvec)."""
    arrays, outs = run
    group0 = [o for o in outs if o["coordinate"][0] == 0]
    x = np.concatenate([o["tp"]["x"] for o in group0], axis=-1)
    x1 = np.concatenate([o["tp"]["x"] for o in outs if o["coordinate"][0] == 1], axis=-1)
    np.testing.assert_array_equal(x1, x)
    A, b = arrays["A_tp"], arrays["b_tp"]
    rj = jax_solve_sharded("mprgp_bb", jnp.asarray(A[0]), jnp.asarray(b[0]), jax_mesh(),
                           proj=jax_box(64), config=cq.models.MPRGPBBConfig(**CONFIG_TP))
    rp = SOLVERS["mprgp_bb"][0](torch.from_numpy(A), torch.from_numpy(b),
                                proj=box(-torch.ones(64), torch.ones(64), dtype=torch.float64),
                                config=SOLVERS["mprgp_bb"][1](**CONFIG_TP))
    r = group0[0]["tp"]
    assert bool(r["converged"][0]) and bool(rj.converged) and bool(rp.converged[0])
    np.testing.assert_allclose(x[0], np.asarray(rj.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(x, rp.x.numpy(), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(x, arrays["x_exact_tp"], rtol=0, atol=1e-5)
    assert abs(int(r["matvecs"][0]) - int(rj.matvecs)) <= 1
    assert abs(int(r["matvecs"][0]) - int(rp.matvecs[0])) <= 1
    assert group0[0]["tp"]["collectives"]["all_gather"] >= int(r["matvecs"][0])


def test_scaling_probe_rows(run):
    """The weak-scaling probe on 1 and 2 ranks: rank 0 is in both meshes
    and reports both rows, rank 1 the second, ranks 2 and 3 none; every
    lane converges; the first row is its own baseline."""
    _, outs = run
    rows = outs[0]["probe"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["batch"] for r in rows] == [4, 8]
    assert all(r["converged"] == 1.0 for r in rows)
    assert rows[0]["efficiency_vs_first"] == 1.0 and rows[1]["efficiency_vs_first"] > 0.05
    assert all(0 < r["occupancy"] <= 1 and r["skew_wall_factor"] >= 1 for r in rows)
    assert [r["devices"] for r in outs[1]["probe"]] == [2]
    assert outs[1]["probe"][0]["max_iterations"] == rows[1]["max_iterations"]
    assert outs[2]["probe"] == outs[3]["probe"] == []


@pytest.mark.parametrize("world,want", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (8, (2, 4)),
                                        (12, (3, 4)), (16, (2, 8)), (32, (4, 8))])
def test_grid_factors_like_jax(world, want):
    """The dry run's (batch, model) factorisation is the JAX dry run's
    (``__graft_entry__.py``; ``tests/test_parallel.py`` holds 12 -> 3 x 4,
    16 -> 2 x 8, 32 -> 4 x 8)."""
    assert grid(world) == want


def test_dryrun_multichip_4(capsys):
    """(g) the dry run on 4 gloo ranks: a 2 x 2 grid, every leg converged,
    the ranks agree, and the line the JAX dry run prints."""
    outs = dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh={'batch': 2, 'model': 2}" in out
    assert "over 4 gloo ranks" in out
    assert "converged=4/4" in out and out.count("converged=True") == 2
    assert len(outs) == WORLD and outs[0]["dp_converged"] == 4


def test_dryrun_multichip_runs_on_the_cards_by_default(monkeypatch):
    """The dry run asks for one card a rank unless the caller asks for the
    CPU: with fewer cards than ranks it raises before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks on device='cuda' need 2 cards, this "
                                           "host has 1; pass device='cpu'"):
        dryrun_multichip(2)


@pytest.mark.parametrize("world,device,error", [
    (0, "cpu", "world=0 must be at least 1"),
    (2, "tpu", "device must be one of"),
])
def test_spawn_ranks_refuses_bad_arguments(world, device, error):
    """No process starts for an empty world or an unknown device."""
    with pytest.raises(ValueError, match=error):
        spawn_ranks(cases.sleep_past, world, 1, device=device, timeout=5)


def test_init_distributed_refuses_a_rank_without_its_card(monkeypatch):
    """A local rank at or past the host's card count raises, naming both,
    before any process group is made (no second rank on a taken card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="local rank 2 needs card 2, and this host has 2"):
        init_distributed("127.0.0.1:1", 3, 2, device="cuda", timeout=5)
    assert not torch.distributed.is_initialized()


def test_entry_main_on_cpu_ranks(capsys):
    """``python -m ccqppy_tpu_torch.entry 2 --device cpu``: the example
    solve, then the dry run over 2 gloo ranks, a (1, 2) grid."""
    main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry OK: [(8, 64), (8,), (8,), (8,)]" in out
    assert "dryrun_multichip OK: mesh={'batch': 1, 'model': 2}" in out
    assert "over 2 gloo ranks" in out and out.count("converged=True") == 2


@pytest.mark.cuda
def test_dryrun_multichip_on_the_cards(capsys):
    """The dry run over NCCL, one card a rank, on every card of the host up
    to 4: every leg converges and the ranks agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = min(torch.cuda.device_count(), 4)
    outs = dryrun_multichip(world, timeout=TIMEOUT)
    out = capsys.readouterr().out
    assert f"over {world} nccl ranks" in out and out.count("converged=True") == 2
    assert len(outs) == world and outs[0]["dp_converged"] == outs[0]["B"]


def test_entry_batched_solve_on_cpu():
    """``entry(device="cpu")``: the example batch (8 QPs of n = 64) solves
    and every lane converges."""
    fn, (As, bs) = entry(device="cpu")
    x, residual, converged, matvecs = fn(As, bs)
    assert x.shape == bs.shape == (8, 64) and bool(converged.all())
    assert float(residual.max()) < 1e-4 and int(matvecs.max()) < 500


def test_spawn_reports_a_failed_rank():
    """A rank that raises ends the run at once with its traceback, though
    the other rank waits in a collective."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(cases.fail_on_rank_1, 2, device="cpu", timeout=60)
    assert time.monotonic() - t0 < 60


def test_spawn_times_out_a_hung_run():
    """Ranks that do not return within the timeout are ended and the call
    raises, well before the ranks would finish."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 of 2 ranks returned nothing within 5"):
        spawn_ranks(cases.sleep_past, 2, 60, device="cpu", timeout=5)
    assert time.monotonic() - t0 < 30


def test_chip_smoke_distributed_modes_on_one_cpu_rank():
    """``chip_smoke.py``'s (m), (n) and (o) calls on one gloo rank at small
    sizes, as the script makes them on one card over NCCL: (m) gives (k)'s
    x bitwise with its matvec count and an all-gather a matvec; (n)
    converges, its row-chunked f64 audit equals the plain one to 1e-12
    relative and is under tol; (o) is ``solve_batched`` lane for lane,
    bitwise, with no collective."""
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    (out,) = spawn_ranks(cases.chip_smoke_modes, 1, root, device="cpu", timeout=TIMEOUT)
    m, n, o = out["m"], out["n"], out["o"]
    assert m["same_x"] and m["matvecs"][0] == m["matvecs"][1]
    assert m["collectives"]["all_gather"] >= m["matvecs"][1]
    assert n["converged"] and n["audit"] <= 2e-5 and n["err"] < 1e-3
    assert abs(n["audit"] - n["plain_audit"]) <= 1e-12 * n["plain_audit"]
    assert n["collectives"]["all_gather"] > 0
    assert o["same"] and not any(o["collectives"].values())
