"""Operator parallelism: one huge QP row-sharded over the ranks of a mesh.

Port of ``ccqppy_tpu/parallel/sharded.py`` onto ``torch.distributed``:
every rank runs the same program (started by ``torchrun``, or by
``parallel.distributed.spawn_ranks`` on one host) and has called
``parallel.distributed.init_distributed``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; the dimension ``axis`` of it
plays the part of the JAX mesh axis.

* A is split into equal contiguous row blocks, one per rank of ``axis`` in
  rank order; b, x0, x and every solver state vector carry the matching
  rows.  Each rank slices its rows out of the global arrays it is given, as
  ``shard_map``'s ``in_specs`` do (a caller who holds only its own rows
  builds a ``ShardedDenseOperator`` and calls the solver itself).
* The UNMODIFIED solvers run on the local rows; the operator
  (``ops.linop.ShardedDenseOperator`` / ``ShardedBlockSparseOperator``)
  all-gathers x for the matvec and reduces dots (SUM), feasible steps
  (MIN) and ``inf_norm`` (MAX) over the axis's process group.
* The projection is cut to the rank's rows (``Projection.shard``): it must
  be separable (box, bounds, identity) or blockwise with blocks aligned to
  the shard boundaries; a ball or a cone over all of x raises.

Communication per iteration: one all-gather of the iterate and a few
all-reduces of (B,) partials.  A rank's solve loop exits on values that
came out of those all-reduces, so every rank runs the same iterations.
"""
from __future__ import annotations

from ccqppy_tpu_torch.ops.linop import ShardedBlockSparseOperator, ShardedDenseOperator
from ccqppy_tpu_torch.parallel.batch import _get_solver, _solver_kwargs
from ccqppy_tpu_torch.parallel.distributed import mesh_1d, mesh_axis


def make_mesh(n_devices=None, axis="model"):
    """1-D mesh named ``axis`` over ranks 0 .. ``n_devices`` - 1 (default:
    every rank).  Every rank calls it; a rank outside the mesh may not
    solve on it."""
    return mesh_1d(n_devices, axis)


def _local_proj(proj, lo, hi, n, proj_sharded):
    """The projection for rows [lo, hi) of n.  A set that couples
    coordinates raises either way (``Projection.shard``)."""
    if proj is None:
        return None
    local = proj.shard(lo, hi, n)
    if proj_sharded:
        return local
    sized = [k for k, v in proj.parameter_buffers() if v.dim() and v.shape[-1] == n]
    if sized and hi - lo != n:
        raise ValueError(f"proj_sharded=False takes parameters shared by every shard, but "
                         f"{sized} have the global size {n}")
    return proj


def _rows(x, lo, hi):
    return None if x is None else x[..., lo:hi]


def solve_sharded(solver, A, b, mesh, axis="model", x0=None, proj=None,
                  config=None, proj_sharded=True):
    """Solve QPs with A (B, n, n) row-sharded over ``mesh[axis]``; a single
    QP is B = 1.  b and x0: (B, n).  Every rank passes the global arrays
    and reads only its own rows of them.

    proj_sharded:
        True  -> the projection's coordinate-sized parameters (bounds of
                 shape (n,) or (B, n)) are cut to the rank's rows.
        False -> the projection carries no arrays (identity) or only ones
                 shared by every shard (scalar bounds, blockwise with
                 shard-aligned blocks and shared child bounds).

    Returns a ``SolveResult`` whose ``x`` is this rank's rows (B, n_local);
    ``residual``, ``converged``, ``matvecs`` and ``iterations`` come from
    all-reduced values and are the same on every rank.
    """
    group, size, rank = mesh_axis(mesh, axis)
    n = b.shape[-1]
    if n % size:
        raise ValueError(f"n={n} must divide the mesh axis size {size}")
    lo, hi = rank * (n // size), (rank + 1) * (n // size)
    op = ShardedDenseOperator(A[:, lo:hi], group)
    return _get_solver(solver)(op, b[:, lo:hi], x0=_rows(x0, lo, hi),
                               proj=_local_proj(proj, lo, hi, n, proj_sharded),
                               **_solver_kwargs(config, None))


def solve_sharded_blocksparse(solver, blocks, cols, b, mesh, axis="model",
                              x0=None, proj=None, config=None,
                              proj_sharded=True):
    """Solve one huge block-sparse QP row-sharded over ``mesh[axis]``.

    A arrives in the ELL layout of ``BlockSparseOperator``: ``blocks`` (B,
    nbr, k_max, bs, bs), ``cols`` (B, nbr, k_max) GLOBAL block-column ids;
    b and x0 (B, n).  Each rank takes its contiguous block rows, and the
    solver carries its rows of x; see ``ShardedBlockSparseOperator``.  The
    number of block rows must divide the axis size, and the projection
    obeys ``solve_sharded``'s constraint.  Returns as ``solve_sharded``.
    """
    group, size, rank = mesh_axis(mesh, axis)
    nbr, bs = blocks.shape[1], blocks.shape[3]
    if nbr % size:
        raise ValueError(f"{nbr} block rows must divide the mesh axis size {size}")
    r0, r1 = rank * (nbr // size), (rank + 1) * (nbr // size)
    n = b.shape[-1]
    op = ShardedBlockSparseOperator(blocks[:, r0:r1], cols[:, r0:r1], n, group)
    lo, hi = r0 * bs, r1 * bs
    return _get_solver(solver)(op, b[:, lo:hi], x0=_rows(x0, lo, hi),
                               proj=_local_proj(proj, lo, hi, n, proj_sharded),
                               **_solver_kwargs(config, None))
