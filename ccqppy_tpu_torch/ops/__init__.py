"""Projection operators, dense, block-sparse and packed symmetric
operators, and the batched GEMV and symv kernels."""
from ccqppy_tpu_torch.ops import gemv, kernels, linop, projections, symv  # noqa: F401
from ccqppy_tpu_torch.ops.gemv import batched_gemv, batched_gemv_reference  # noqa: F401
from ccqppy_tpu_torch.ops.symv import (batched_symv, batched_symv_packed,  # noqa: F401
                                       pack_symmetric, symv_packed)
from ccqppy_tpu_torch.ops.linop import BlockSparseOperator  # noqa: F401
