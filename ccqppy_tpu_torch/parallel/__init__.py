"""Batched solves with straggler compaction, and the bf16 -> f32 ladder."""
from ccqppy_tpu_torch.parallel.batch import (host_compact_finish, solve_batched,
                                             solve_batched_compact,
                                             solve_batched_fused_compact)
from ccqppy_tpu_torch.parallel.mixed import prepare_dense_batch, solve_batched_mixed

__all__ = ["solve_batched", "solve_batched_compact", "solve_batched_fused_compact",
           "host_compact_finish",
           "prepare_dense_batch", "solve_batched_mixed"]
