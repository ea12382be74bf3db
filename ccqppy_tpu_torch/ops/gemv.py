"""Batched dense GEMV ``y[b] = A[b] @ x[b]``: the solver's only
operator-sized memory stream.

Port of ``batched_gemv`` in ``ccqppy_tpu/ops/pallas_kernels.py``.  On a
CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/batched_gemv.cu`` or raises; on a CPU tensor it computes the plain
version ``batched_gemv_reference``.  No other path exists: a CUDA tensor
never falls back to the plain version.

The kernel takes any n and any base alignment of A and x through one
code path, so the TPU package's ``padded_batched_gemv`` (padding n to a
multiple of 128) has no counterpart here.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.ops import kernels

#: Number of kernel launches in this process.  Only a CUDA launch adds to
#: it; the plain version on the CPU does not.
LAUNCHES = 0
#: The bf16 launches among ``LAUNCHES`` (the cheap sweeps of ``CastDense``
#: and ``MixedPrecDense``).
LAUNCHES_BF16 = 0


def batched_gemv_reference(A, x):
    """Plain version, in the JAX operators' dtypes: for f32 or f64 ``A``
    products and sums in ``promote(A.dtype, x.dtype)``; for bf16 ``A``, x is
    rounded to bf16 first, as the kernel does, and the sums run in
    ``promote(x.dtype, float32)``.  The result has the dtype of the sums."""
    if A.dtype == torch.bfloat16:
        acc = torch.promote_types(x.dtype, torch.float32)
        x = x.to(torch.bfloat16)
    else:
        acc = torch.promote_types(A.dtype, x.dtype)
    return torch.einsum("bij,bj->bi", A.to(acc), x.to(acc))


def _check(A, x):
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    if x.shape != A.shape[:2]:
        raise ValueError(f"x must be (B, n) = {tuple(A.shape[:2])}, got {tuple(x.shape)}")
    if A.device != x.device:
        raise ValueError(f"A on {A.device} but x on {x.device}")


def _check_kernel_operands(A, x):
    """What the CUDA kernel takes beyond ``_check``: float32 or bfloat16 A,
    float32 x, both contiguous (at any storage offset)."""
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 A, not {A.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 x, not {x.dtype}")
    if not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous A and x")


def batched_gemv(A, x):
    """y[b] = A[b] @ x[b] for A (B, n, n) and x (B, n) -> (B, n).

    On CUDA: A is float32 or bfloat16 and x float32, both contiguous, the
    kernel runs on the current stream and y is float32.  On the CPU: the
    plain version, in any floating dtype.
    """
    global LAUNCHES, LAUNCHES_BF16
    _check(A, x)
    if A.device.type == "cpu":
        return batched_gemv_reference(A, x)
    if A.device.type != "cuda":
        raise ValueError(f"batched_gemv runs on cuda or cpu, not {A.device}")
    _check_kernel_operands(A, x)
    B, n = x.shape
    y = torch.empty((B, n), dtype=torch.float32, device=A.device)
    if B == 0 or n == 0:
        return y
    lib = kernels.load()
    fn = lib.batched_gemv_f32 if A.dtype == torch.float32 else lib.batched_gemv_bf16
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), x.data_ptr(), y.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError(f"batched_gemv kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    if A.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    return y
