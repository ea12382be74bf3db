"""Rank-side cases of the port's distributed tests.

``tests/test_torch_sharded.py`` and ``tests/test_torch_distributed.py``
run ``sharded_cases`` and ``distributed_cases`` once each on gloo CPU ranks
(``ccqppy_tpu_torch.parallel.distributed.spawn_ranks``): every rank
gets the same numpy problems, solves its share through the port's
distributed layer, and returns numpy results that the test process holds
against the JAX package and the port's unsharded solves.  This module
imports torch and the port only: spawn imports it anew in each rank.
"""
import importlib.util
import time

import torch
import torch.distributed as dist

from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.linop import ShardedDenseOperator
from ccqppy_tpu_torch.ops.projections import ball, blockwise, box, lorentz_cone
from ccqppy_tpu_torch.parallel import (init_distributed, make_batch_mesh, make_hybrid_mesh,
                                       make_mesh, scaling_probe, solve_batched,
                                       solve_batched_sharded, solve_sharded,
                                       solve_sharded_blocksparse)
from ccqppy_tpu_torch.parallel.distributed import COLLECTIVES
from ccqppy_tpu_torch.utils.random_qp import block_tridiag_qp, random_qp_batch

F64 = torch.float64


def config(solver, kwargs):
    return SOLVERS[solver][1](**kwargs)


def unit_box(n, lo=-1.0):
    return box(lo * torch.ones(n), torch.ones(n), dtype=F64)


def summary(r):
    """A SolveResult as numpy: this rank's x, and the fields every rank
    shares."""
    return {"x": r.x.numpy(), "residual": r.residual.numpy(), "converged": r.converged.numpy(),
            "matvecs": r.matvecs.numpy(), "iterations": r.iterations.numpy()}


def collectives_of(fn):
    """(fn's result, the collectives it made by kind)."""
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))
    out = fn()
    return out, dict(COLLECTIVES)


def raised(fn):
    """The message of the ValueError ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def sharded_cases(p):
    """Cases (a)-(e) and (h) of ``test_torch_sharded.py`` on a 1-D mesh
    over every rank; ``p`` holds the problems and configs."""
    t = {k: torch.from_numpy(v) for k, v in p["arrays"].items()}
    mesh = make_mesh(axis="model")
    out = {}
    # (a) the dense solvers on one QP.
    n = t["A_a"].shape[-1]
    for solver, kwargs in p["configs_a"].items():
        r, counts = collectives_of(lambda: solve_sharded(
            solver, t["A_a"], t["b_a"], mesh, proj=unit_box(n), config=config(solver, kwargs)))
        out["a", solver] = {**summary(r), "collectives": counts}
    # (b) Jacobi PCG through the sharded diagonal.
    n_local = n // mesh.size(0)
    rank = mesh.get_local_rank(0)
    rows = t["A_b"][:, rank * n_local:(rank + 1) * n_local]
    out["b_diag"] = ShardedDenseOperator(rows, mesh.get_group(0)).diagonal().numpy()
    r = solve_sharded("pcg", t["A_b"], t["b_b"], mesh, proj=unit_box(n),
                      config=config("pcg", p["config_b"]))
    out["b"] = summary(r)
    # (c) PCG on box QPs with many active bounds.
    for i in range(t["A_c"].shape[0]):
        r = solve_sharded("pcg", t["A_c"][i:i + 1], t["b_c"][i:i + 1], mesh, proj=unit_box(n),
                          config=config("pcg", p["config_c"]))
        out["c", i] = summary(r)
    # (d) the block-sparse operator.
    n_d = t["b_d"].shape[-1]
    for solver, kwargs in p["configs_d"].items():
        r = solve_sharded_blocksparse(solver, t["blocks_d"], t["cols_d"], t["b_d"], mesh,
                                      proj=unit_box(n_d), config=config(solver, kwargs))
        out["d", solver] = summary(r)
    # (e) scenario sharding: no collective inside the solve.
    bmesh = make_batch_mesh()
    n_e = t["b_e"].shape[-1]
    r, counts = collectives_of(lambda: solve_batched_sharded(
        "bbpgd", t["A_e"], t["b_e"], bmesh, proj=unit_box(n_e),
        config=config("bbpgd", p["config_e"])))
    out["e", "bbpgd"] = {**summary(r), "collectives": counts}
    r, counts = collectives_of(lambda: solve_batched_sharded(
        "spg", t["A_e"], t["b_e"], bmesh, proj=unit_box(n_e),
        config=config("spg", p["config_e_spg"]), keys=t["keys_e"]))
    out["e", "spg"] = {**summary(r), "collectives": counts}
    # (h) sets the row sharding cannot take, and one it can.
    pcg_cfg = config("pcg", p["config_c"])
    out["h", "ball"] = raised(lambda: solve_sharded(
        "pcg", t["A_a"], t["b_a"], mesh, proj=ball(2.0, dtype=F64), config=pcg_cfg))
    out["h", "cone_across"] = raised(lambda: solve_sharded(
        "mprgp_bb", t["A_a"], t["b_a"], mesh, proj=blockwise(lorentz_cone(1.0, dtype=F64), 3),
        config=config("mprgp_bb", p["config_h"])))
    out["h", "shared_bounds"] = raised(lambda: solve_sharded(
        "pcg", t["A_a"], t["b_a"], mesh, proj=unit_box(n), config=pcg_cfg, proj_sharded=False))
    r = solve_sharded("pcg", t["A_c"][:1], t["b_c"][:1], mesh,
                      proj=box(-1.0, 1.0, dtype=F64), config=pcg_cfg, proj_sharded=False)
    out["h", "scalar_bounds"] = summary(r)
    r = solve_sharded("mprgp_bb", t["A_h"], t["b_h"], mesh,
                      proj=blockwise(lorentz_cone(1.0, dtype=F64), 3),
                      config=config("mprgp_bb", p["config_h"]))
    out["h", "cone_aligned"] = summary(r)
    r = solve_sharded("pcg", t["A_h"], t["b_h"], mesh,
                      proj=blockwise(box(t["lb_h"], t["ub_h"], dtype=F64), 3, child_axes=0),
                      config=pcg_cfg)
    out["h", "per_block_bounds"] = summary(r)
    return out


def distributed_cases(p):
    """Cases (f) and (i), the scaling probe and the hybrid mesh's checks of
    ``test_torch_distributed.py``, on 4 ranks."""
    t = {k: torch.from_numpy(v) for k, v in p["arrays"].items()}
    out = {"init": init_distributed(device="cpu")}          # (i): joined already
    out["init_other_backend"] = raised(lambda: init_distributed(device="cuda"))
    # (f) the (2, 2) grid: dp over batch, tp over model.
    mesh = make_hybrid_mesh(ici_size=2)
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out["coordinate"] = list(mesh.get_coordinate())
    n = t["b_dp"].shape[-1]
    r, counts = collectives_of(lambda: solve_batched_sharded(
        "bbpgd", t["A_dp"], t["b_dp"], mesh, axis="batch", proj=unit_box(n),
        config=config("bbpgd", p["config_dp"])))
    out["dp"] = {**summary(r), "collectives": counts}
    n_big = t["b_tp"].shape[-1]
    r, counts = collectives_of(lambda: solve_sharded(
        "mprgp_bb", t["A_tp"], t["b_tp"], mesh, axis="model", proj=unit_box(n_big),
        config=config("mprgp_bb", p["config_tp"])))
    out["tp"] = {**summary(r), "collectives": counts}
    out["ici_3"] = raised(lambda: make_hybrid_mesh(ici_size=3))
    default = make_hybrid_mesh()
    out["default_mesh"] = dict(zip(default.mesh_dim_names, default.shape))
    out["probe"] = scaling_probe([1, 2], batch_per_device=4, n=32, max_matvecs=2000, reps=1,
                                 tol=1e-8, dtype=F64)
    return out


def fail_on_rank_1():
    """Rank 1 raises; the others wait in a collective it never joins."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleep_past(seconds):
    """Every rank outlives the launcher's timeout."""
    time.sleep(seconds)


def chip_smoke_modes(root):
    """``chip_smoke.py``'s (m), (n) and (o) calls at small sizes on this
    rank's CPU group: (m) against (k)'s call, (o) against
    ``solve_batched``, and the collectives each made."""
    spec = importlib.util.spec_from_file_location("chip_smoke", f"{root}/chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mesh = make_mesh(axis="model")
    out = {}
    op, b, _ = block_tridiag_qp(400, 0, dtype=F64)
    proj, cfg = unit_box(400), PCGConfig(tol=1e-9, max_matvecs=10_000)
    r_k = cs.run_huge(op, b, proj, cfg)
    r_m, counts = collectives_of(lambda: cs.run_huge_sharded(op, b, proj, cfg, mesh))
    out["m"] = {"same_x": torch.equal(r_m.x, r_k.x), "matvecs": (int(r_k.matvecs[0]),
                int(r_m.matvecs[0])), "collectives": counts}
    A, b, x = random_qp_batch(torch.Generator().manual_seed(5), 1, 256, F64, diag_boost=1.0)
    cfg = PCGConfig(tol=2e-5, max_matvecs=500, precond="jacobi")
    r_n, counts = collectives_of(lambda: cs.run_dense_sharded(A, b, unit_box(256), cfg, mesh))
    audit = cs.audit_rows(A, b, r_n.x, chunk=100)
    plain = cs.pg_residual(unit_box(256), r_n.x, (A @ r_n.x[..., None])[..., 0] + b, 1e-6)
    out["n"] = {"converged": bool(r_n.converged.all()), "audit": float(audit.max()),
                "plain_audit": float(plain.max()), "err": float((r_n.x - x).abs().max()),
                "collectives": counts}
    As, bs, _ = random_qp_batch(torch.Generator().manual_seed(7), 16, 64, F64, diag_boost=1.0)
    diag = As.diagonal(dim1=-2, dim2=-1)
    cfg = PCGConfig(tol=2e-5, max_matvecs=500)
    r_ref = solve_batched("pcg", As, bs, x0=cs.jacobi_x0(diag, bs), proj=unit_box(64), config=cfg)
    r_o, counts = collectives_of(lambda: cs.run_scenario_sharded(
        As, bs, diag, unit_box(64), cfg, make_batch_mesh()))
    out["o"] = {"same": torch.equal(r_o.x, r_ref.x) and torch.equal(r_o.matvecs, r_ref.matvecs),
                "collectives": counts}
    return out
