"""Entry points of the port: one batched solve, and a multi-rank dry run.

Counterpart of ``__graft_entry__.py``:

``entry()``             -- (fn, example_args): the batched box-QP solve with
                          PCG at example scale, on the card unless the caller
                          asks for the CPU.
``dryrun_multichip(w)`` -- one step of the full distributed layer on ``w``
                          ranks, on tiny shapes: a (batch, model) grid from
                          ``make_hybrid_mesh``, scenario batching over
                          ``batch`` composed with a row-sharded QP over
                          ``model`` (dense and block-sparse).  Its ranks
                          are processes of this host (``spawn_ranks``): one
                          card a rank over NCCL, or, when the caller asks
                          for the CPU, gloo ranks, the counterpart of the
                          JAX package's virtual CPU devices.

Run:  python -m ccqppy_tpu_torch.entry [WORLD] [--device cuda|cpu]
      (WORLD defaults to the cards present on "cuda", to 4 on "cpu")
"""
from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as sp
import torch

from ccqppy_tpu_torch.models import BBPGDConfig, MPRGPBBConfig, PCGConfig, pcg
from ccqppy_tpu_torch.ops.collectives import all_reduce
from ccqppy_tpu_torch.ops.linop import BlockSparseOperator
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import (make_hybrid_mesh, solve_batched, solve_batched_sharded,
                                       solve_sharded, solve_sharded_blocksparse)
from ccqppy_tpu_torch.parallel.distributed import BACKENDS, mesh_axis, spawn_ranks
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch


def _example_batch(batch, n, dtype=torch.float32, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    As, bs, _ = random_qp_batch(gen, batch, n, dtype, diag_boost=1.0)
    return As, bs


def entry(device="cuda"):
    """Return (fn, example_args): ``fn(As, bs)`` solves the box-QP batch
    with PCG and returns (x, residual, converged, matvecs)."""
    batch, n = 8, 64
    As, bs = _example_batch(batch, n, device=device)
    proj = box(-torch.ones(n), torch.ones(n), device=device)
    cfg = PCGConfig(tol=1e-4, max_matvecs=500)

    def fn(As, bs):
        r = pcg.solve(As, bs, proj=proj, config=cfg)
        return r.x, r.residual, r.converged, r.matvecs

    return fn, (As, bs)


def grid(world):
    """(batch, model) sizes for ``world`` ranks, both above 1 where the
    count allows (8 -> 2 x 4, 4 -> 2 x 2, 12 -> 3 x 4), as the JAX dry run
    factors its devices."""
    model = 1
    for cand in (2, 4, 8):
        if world % cand == 0 and world // cand >= 2:
            model = cand
    if model == 1 and world % 2 == 0:
        model = 2  # 2 ranks: keep the tp axis genuine
    return world // model, model


def _block_tridiag(model, dtype=torch.float32, device="cpu"):
    """The dry run's block-sparse QP: block-tridiagonal, 4x4 blocks, 4
    block rows a rank of ``model``, from numpy's seed 2 as in the JAX dry
    run."""
    bsz, nbr = 4, 4 * model
    n = bsz * nbr
    rng = np.random.default_rng(2)
    Ad = np.zeros((n, n), np.float32)
    for i in range(nbr):
        for j in range(max(0, i - 1), min(nbr, i + 2)):
            Ad[i * bsz:(i + 1) * bsz, j * bsz:(j + 1) * bsz] = \
                0.1 * rng.standard_normal((bsz, bsz))
    Ad = 0.5 * (Ad + Ad.T) + 2.0 * np.eye(n, dtype=np.float32)
    op = BlockSparseOperator.from_scipy_bsr(sp.bsr_matrix(Ad, blocksize=(bsz, bsz)),
                                            dtype=dtype, device=device)
    b = torch.as_tensor(-Ad @ rng.uniform(-0.5, 0.5, n), dtype=dtype, device=device)[None]
    return op, b


def _dryrun_rank(world, device):
    """One rank of ``dryrun_multichip``: the three legs on this rank's
    device; returns what they found, the same on every rank."""
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        # The row-sharded dense product is a torch.matmul: keep f32 IEEE.
        torch.backends.cuda.matmul.allow_tf32 = False
    batch_axis, model = grid(world)
    mesh = make_hybrid_mesh(dcn_axis="batch", ici_axis="model", ici_size=model)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if shape != {"batch": batch_axis, "model": model}:
        raise RuntimeError(f"hybrid mesh shape {shape}")
    dtype = torch.float32

    # --- dp leg: scenario ensemble sharded over the batch axis -------------
    B, n = 2 * batch_axis, 16
    As, bs = _example_batch(B, n, dtype, device=device)
    proj = box(-torch.ones(n), torch.ones(n), device=device)
    cfg = BBPGDConfig(tol=1e-3, max_matvecs=200)
    r_dp = solve_batched_sharded("bbpgd", As, bs, mesh, axis="batch", proj=proj, config=cfg)
    # The lanes spread over the batch axis: each group solved its own slice,
    # lane for lane what the unsharded solve of those lanes gives.
    group, size, index = mesh_axis(mesh, "batch")
    lanes = slice(index * B // size, (index + 1) * B // size)
    own = solve_batched("bbpgd", As[lanes], bs[lanes], proj=proj, config=cfg)
    if r_dp.x.shape != (B // size, n) or not torch.equal(r_dp.x, own.x):
        raise RuntimeError(f"dp lanes {lanes} differ from the unsharded solve's")
    dp_converged = int(all_reduce(r_dp.converged.sum()[None], "sum", group))

    # --- tp leg: one QP row-sharded over the model axis ---------------------
    n_big = 16 * model
    A1, b1 = _example_batch(1, n_big, dtype, seed=1, device=device)
    r_tp = solve_sharded("mprgp_bb", A1, b1, mesh, axis="model",
                         proj=box(-torch.ones(n_big), torch.ones(n_big), device=device),
                         config=MPRGPBBConfig(tol=1e-3, max_matvecs=200))
    if r_tp.x.shape != (1, n_big // model):
        raise RuntimeError(f"tp leg x {tuple(r_tp.x.shape)}")

    # --- tp leg, block-sparse: the n=1M ELL configuration at tiny scale -----
    op, b_sp = _block_tridiag(model, dtype, device)
    r_sp = solve_sharded_blocksparse("pcg", op.blocks, op.cols, b_sp, mesh, axis="model",
                                     proj=box(-torch.ones(op.n), torch.ones(op.n), device=device),
                                     config=PCGConfig(tol=1e-3, max_matvecs=200))
    if r_sp.x.shape != (1, op.n // model):
        raise RuntimeError(f"tp block-sparse leg x {tuple(r_sp.x.shape)}")
    return {"mesh": shape, "B": B, "n": n, "dp_converged": dp_converged,
            "n_big": n_big, "tp_converged": bool(r_tp.converged.all()),
            "tp_matvecs": int(r_tp.matvecs[0]), "n_sp": op.n,
            "sp_converged": bool(r_sp.converged.all()), "sp_matvecs": int(r_sp.matvecs[0])}


def dryrun_multichip(world: int, device="cuda", timeout=120.0):
    """One full step over ``world`` ranks (``grid(world)``): dp (scenario
    batch) x tp (row-sharded QP), on tiny shapes.  ``device="cuda"`` runs
    one card a rank over NCCL and raises unless this host has ``world``
    cards; ``device="cpu"`` runs gloo ranks on the CPU.  Prints one line and
    returns every rank's summary; raises if a leg fails or a rank does not
    finish within ``timeout`` seconds."""
    outs = spawn_ranks(_dryrun_rank, world, world, device, device=device, timeout=timeout)
    if any(o != outs[0] for o in outs):
        raise RuntimeError(f"the ranks disagree: {outs}")
    o = outs[0]
    print(f"dryrun_multichip OK: mesh={o['mesh']} via make_hybrid_mesh over {world} "
          f"{BACKENDS[device]} ranks; dp batch {o['B']}x n={o['n']} "
          f"converged={o['dp_converged']}/{o['B']}; "
          f"tp n={o['n_big']} converged={o['tp_converged']}; "
          f"tp-blocksparse n={o['n_sp']} converged={o['sp_converged']}")
    return outs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("world", nargs="?", type=int,
                        help="ranks (default: the cards present, or 4 on the CPU)")
    parser.add_argument("--device", choices=sorted(BACKENDS), default="cuda")
    args = parser.parse_args(argv)
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 4)
    fn, example = entry(device=args.device)
    print("entry OK:", [tuple(o.shape) for o in fn(*example)])
    dryrun_multichip(world, device=args.device)


if __name__ == "__main__":
    main()
