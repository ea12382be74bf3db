"""Batched solves with straggler compaction, the bf16 -> f32 ladder, and the
distributed layer: scenario batches and single huge QPs sharded over the
ranks of a ``torch.distributed`` mesh."""
from ccqppy_tpu_torch.parallel.batch import (host_compact_finish, make_batch_mesh,
                                             solve_batched, solve_batched_compact,
                                             solve_batched_fused_compact,
                                             solve_batched_sharded)
from ccqppy_tpu_torch.parallel.distributed import (init_distributed, make_hybrid_mesh,
                                                   scaling_probe)
from ccqppy_tpu_torch.parallel.mixed import prepare_dense_batch, solve_batched_mixed
from ccqppy_tpu_torch.parallel.sharded import (make_mesh, solve_sharded,
                                               solve_sharded_blocksparse)

__all__ = ["solve_batched", "solve_batched_compact", "solve_batched_fused_compact",
           "solve_batched_sharded", "make_batch_mesh", "host_compact_finish",
           "solve_batched_mixed", "prepare_dense_batch",
           "solve_sharded", "solve_sharded_blocksparse", "make_mesh",
           "init_distributed", "make_hybrid_mesh", "scaling_probe"]
