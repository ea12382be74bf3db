"""Process groups, meshes and multi-rank runs on ``torch.distributed``.

Port of ``ccqppy_tpu/parallel/distributed.py``.  JAX's multi-controller
runtime becomes PyTorch's: every rank (one process, one device) runs the
same program, ``init_distributed`` joins the ranks into one process group,
and the collectives are NCCL calls on CUDA tensors or gloo calls on CPU
tensors.  This module owns:

* ``init_distributed()``  -- idempotent ``dist.init_process_group``.  The
  backend follows the device the caller names: NCCL for ``"cuda"``, gloo
  for ``"cpu"``.  With no address it reads the standard environment of
  ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``).
* ``make_hybrid_mesh()``  -- a 2-D ``DeviceMesh`` (outer, inner): the inner
  axis spans the ranks of one host (NVLink), the outer axis the hosts.
  Scenario batches go on the outer axis (collective-free), row-sharded
  QPs on the inner one (an all-gather an iteration), so no iteration's
  collective crosses hosts.
* ``scaling_probe()``     -- iterations/s of scenario-sharded solves on 1..N
  ranks.
* ``COLLECTIVES``         -- the collective calls of the sharded operators
  by kind (``ops.collectives.COUNTS``).
* ``spawn_ranks()``       -- run a function on N fresh processes of one
  host, one card a rank over NCCL, or CPU ranks over gloo when the caller
  asks for the CPU (the multi-rank path checked without a cluster).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import socket
import statistics
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ccqppy_tpu_torch.ops import collectives

#: Collective calls of the sharded operators by kind; set the values to 0
#: to count a run.
COLLECTIVES = collectives.COUNTS

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_MESH_DEVICE = {backend: device for device, backend in BACKENDS.items()}


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     device="cuda", timeout=300.0):
    """Join this process to the process group, once; returns (rank, world).

    ``coordinator_address`` ("host:port", rank 0 listens there),
    ``num_processes`` and ``process_id``; or none of them, and the
    ``torchrun`` environment gives all three.  ``device`` picks the
    backend: "cuda" is NCCL on the card ``LOCAL_RANK`` (else
    ``process_id``), which must exist, "cpu" is gloo.  ``timeout``
    (seconds) bounds the rendezvous and every collective: a rank that never
    arrives fails the call.  A second call returns the group it made, and
    raises if it asks for another backend.
    """
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, not {device!r}")
    backend = BACKENDS[device]
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not the "
                             f"{backend} that device={device!r} asks for")
        return dist.get_rank(), dist.get_world_size()
    kwargs = {"backend": backend, "timeout": datetime.timedelta(seconds=timeout),
              "init_method": "env://" if coordinator_address is None
              else f"tcp://{coordinator_address}"}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA device")
        local, cards = int(os.environ.get("LOCAL_RANK", process_id or 0)), torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(f"local rank {local} needs card {local}, and this host has "
                               f"{cards}: start at most one rank a card")
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**kwargs)
    return dist.get_rank(), dist.get_world_size()


def mesh_device_type():
    """The mesh device type of the process group's backend."""
    return _MESH_DEVICE[dist.get_backend()]


def mesh_1d(n_devices, axis):
    """1-D mesh named ``axis`` over ranks 0 .. ``n_devices`` - 1 (None: all)."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} must be within 1..{world} ranks")
    return DeviceMesh(mesh_device_type(), torch.arange(n), mesh_dim_names=(axis,))


def mesh_axis(mesh, axis):
    """(process group, size, this rank's index) of the dimension ``axis`` of
    ``mesh``; raises if this rank is not in the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def make_hybrid_mesh(dcn_axis="batch", ici_axis="model", ici_size=None):
    """2-D mesh (``dcn_axis``, ``ici_axis``) over every rank.  The inner
    ``ici_axis`` holds ``ici_size`` consecutive ranks (default: the ranks of
    one host, ``LOCAL_WORLD_SIZE``, else all): ``torchrun`` numbers a host's
    ranks consecutively, so that axis stays on NVLink.  Shard scenario
    batches over ``dcn_axis`` and row-shard QPs over ``ici_axis``."""
    world = dist.get_world_size()
    ici = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if ici_size is None else int(ici_size)
    if ici < 1 or world % ici:
        raise ValueError(f"ici_size={ici} must divide {world} ranks")
    return init_device_mesh(mesh_device_type(), (world // ici, ici),
                            mesh_dim_names=(dcn_axis, ici_axis))


def scaling_probe(n_devices_list=None, batch_per_device=64, n=256, solver="pcg",
                  tol=1e-5, max_matvecs=400, reps=3, dtype=torch.float32):
    """Scenario-parallel iterations/s on 1..N ranks (weak scaling).

    For each rank count k, ``k * batch_per_device`` box QPs of n (``A = G
    G^T + n I``, seed 0) are solved by ``solve_batched_sharded`` over the
    first k ranks, on the process group's device, timed by
    ``utils.benchmark.timed_run``.  The row's lanes are gathered over the k
    ranks and its wall is the slowest rank's.  Fields as in the JAX
    package: iterations and solves per second, converged share, wall,
    max and median iterations, ``occupancy`` (lane iterations over lanes
    times the slowest lane's) and ``skew_wall_factor`` (slowest over
    median), and ``efficiency_vs_first`` against the first row.  Every
    rank calls it; a rank returns the rows of the meshes it is in (rank 0:
    all of them)."""
    from ccqppy_tpu_torch.models import SOLVERS
    from ccqppy_tpu_torch.ops.projections import box
    from ccqppy_tpu_torch.parallel.batch import make_batch_mesh, solve_batched_sharded
    from ccqppy_tpu_torch.utils.benchmark import timed_run
    from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

    world = dist.get_world_size()
    if n_devices_list is None:
        n_devices_list = [k for k in (1, 2, 4, 8, 16, 32) if k <= world]
    device = torch.device("cuda", torch.cuda.current_device()) \
        if mesh_device_type() == "cuda" else torch.device("cpu")
    cfg = SOLVERS[solver][1](tol=tol, max_matvecs=max_matvecs)
    proj = box(-torch.ones(n), torch.ones(n), dtype=dtype, device=device)
    rows, base = [], None
    for k in n_devices_list:
        mesh = make_batch_mesh(k)
        if mesh.get_coordinate() is None:
            continue
        group = mesh.get_group(0)
        B = k * batch_per_device
        gen = torch.Generator(device=device).manual_seed(0)
        As, bs, _ = random_qp_batch(gen, B, n, dtype, diag_boost=1.0)

        def run():
            return solve_batched_sharded(solver, As, bs, mesh, axis="batch", proj=proj,
                                         config=cfg)

        # The warm call's matvecs set a conservative traffic floor for the
        # guard: half of this rank's operator reads.
        mv = int(run().matvecs.sum())
        out = timed_run(run, reps=reps, implied_bytes=0.5 * mv * n * n * As.element_size())
        r = out.result
        its = collectives.all_gather_last(r.iterations.to(torch.int64)[None], group)[0]
        conv = collectives.all_gather_last(r.converged.to(dtype)[None], group)[0]
        wall = torch.tensor([out.wall_s], dtype=torch.float64, device=device)
        t = float(collectives.all_reduce(wall, "max", group))
        total, gmax = int(its.sum()), int(its.max())
        median = statistics.median(its.tolist())
        row = {"devices": k, "batch": B, "n": n,
               "iterations_per_s": total / t, "solves_per_s": B / t,
               "converged": float(conv.mean()), "wall_s": t,
               "max_iterations": gmax, "median_iterations": float(median),
               "occupancy": total / (B * gmax) if gmax else 1.0,
               "skew_wall_factor": gmax / max(float(median), 1.0)}
        if base is None:
            base = row["iterations_per_s"] / k
        row["efficiency_vs_first"] = row["iterations_per_s"] / (k * base)
        rows.append(row)
    return rows


def free_port():
    """A TCP port on 127.0.0.1 that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, timeout, results, args):
    """One rank of ``spawn_ranks``: join the group, run ``fn``, report
    (rank, ok, result or traceback)."""
    torch.set_num_threads(1)
    # The ranks share one host: rank r drives card r, and NCCL meets on the
    # loopback interface, where the rendezvous is.
    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        init_distributed(f"127.0.0.1:{port}", world, rank, device=device, timeout=timeout)
        value = fn(*args)
        dist.barrier()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, value))


def spawn_ranks(fn, world, *args, device="cuda", timeout=120.0):
    """Run ``fn(*args)`` on ``world`` fresh processes joined by a process
    group on 127.0.0.1, and return each rank's result in rank order.
    ``device`` as in ``init_distributed``: "cuda" puts rank r on card r
    over NCCL and raises unless the host has ``world`` cards; "cpu" runs
    gloo ranks on the CPU.  ``fn`` must be importable by name (the
    processes are spawned and import it anew) and its result picklable.
    Every wait is bounded by ``timeout`` seconds, which also bounds each
    collective: a rank that fails, or that has not returned in time, ends
    every rank and raises."""
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, not {device!r}")
    if world < 1:
        raise ValueError(f"world={world} must be at least 1")
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks on device='cuda' need {world} cards, this host "
                           f"has {torch.cuda.device_count()}; pass device='cpu' for gloo ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, port, device, timeout, results, args),
                         daemon=True) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    done, finished = {}, False
    try:
        while len(done) < world:
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue_mod.Empty:
                raise TimeoutError(f"{world - len(done)} of {world} ranks returned nothing "
                                   f"within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            done[rank] = value
        finished = True
    finally:
        for p in procs:
            if finished:
                p.join(max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
            p.join(10.0)
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
    return [done[rank] for rank in range(world)]
