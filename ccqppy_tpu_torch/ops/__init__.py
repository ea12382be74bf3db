"""Projection operators, dense linear operators and the batched GEMV kernel."""
from ccqppy_tpu_torch.ops import gemv, kernels, linop, projections  # noqa: F401
from ccqppy_tpu_torch.ops.gemv import batched_gemv, batched_gemv_reference  # noqa: F401
