"""Batched solves with straggler compaction."""
from ccqppy_tpu_torch.parallel.batch import (host_compact_finish, solve_batched,
                                             solve_batched_fused_compact)

__all__ = ["solve_batched", "solve_batched_fused_compact", "host_compact_finish"]
