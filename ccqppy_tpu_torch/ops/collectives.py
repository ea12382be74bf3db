"""Counted collectives of the row-sharded operators (``ops.linop``).

The JAX package's sharded operators call ``lax.all_gather`` (tiled) and
``lax.psum`` / ``pmin`` / ``pmax`` over a mesh axis inside ``shard_map``.
Here they are ``torch.distributed`` calls on a process group: NCCL on CUDA
tensors, gloo on CPU tensors, whichever backend the group was made with
(``parallel.distributed.init_distributed``).  Every call adds one to
``COUNTS`` under its kind, and nothing else does, so a run can show how
many collectives it made (``parallel.distributed.COLLECTIVES`` is the same
dict).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: Collective calls by kind since the last reset (set the values to 0).
COUNTS = {"all_gather": 0, "all_reduce_sum": 0, "all_reduce_min": 0, "all_reduce_max": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_gather_last(x, group=None):
    """The ranks' ``x`` (..., m), each the same shape, joined along the last
    axis in rank order: (..., world * m), the tiled ``all_gather`` of the
    JAX package."""
    world = dist.get_world_size(group)
    x = x.contiguous()
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty((world * flat.shape[0], flat.shape[1]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    COUNTS["all_gather"] += 1
    # (world, rows, m) -> (rows, world, m): a view when there is one row or one rank.
    joined = out.view(world, *flat.shape).transpose(0, 1).reshape(flat.shape[0], -1)
    return joined.view(*x.shape[:-1], world * x.shape[-1])


def all_reduce(t, op, group=None):
    """``t`` reduced in place over the ranks with ``op`` ("sum", "min" or
    "max") and returned; every rank receives the same values."""
    dist.all_reduce(t, op=_OPS[op], group=group)
    COUNTS[f"all_reduce_{op}"] += 1
    return t
