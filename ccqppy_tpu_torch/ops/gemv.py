"""Batched dense GEMV ``y[b] = A[b] @ x[b]``: the solver's only
operator-sized memory stream.

Port of ``batched_gemv`` in ``ccqppy_tpu/ops/pallas_kernels.py``.  On a
CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/batched_gemv.cu`` or raises; on a CPU tensor it computes the plain
version ``batched_gemv_reference``.  No other path exists: a CUDA tensor
never falls back to the plain version.

The kernel has four instances, one for each pair (A, x) a path runs:
(f32, f32) and (bf16, f32), the TPU kernel's; (f64, f64), the f64
``DenseOperator`` and the exact sweep of the f64-exact rung (an XLA dot in
the JAX package); and (f32, f64), an f32 stack against an f64 x with f64
sums, MPRGP's sweeps and audits of an f32 solve (``LinearOperator.matvec_f64``).
bf16 A with f64 x is on no path and has no instance: on CUDA it raises.

The kernel takes any n and any base alignment of A and x through one
code path, so the TPU package's ``padded_batched_gemv`` (padding n to a
multiple of 128) has no counterpart here.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.ops import kernels

#: Number of kernel launches in this process.  Only a CUDA launch adds to
#: it; the plain version on the CPU does not.  A launch captured in a CUDA
#: graph counts once a replay (``kernels.graph_capture``).
LAUNCHES = 0
#: The bf16 launches among ``LAUNCHES`` (the cheap sweeps of ``CastDense``
#: and ``MixedPrecDense``).
LAUNCHES_BF16 = 0
#: The f64 launches among ``LAUNCHES`` (f64 ``DenseOperator``, the exact
#: sweep of the f64-exact rung).
LAUNCHES_F64 = 0
#: The (f32 A, f64 x) launches among ``LAUNCHES`` (MPRGP's sweeps below f64).
LAUNCHES_F32_F64 = 0
#: Lanes of A the launches among ``LAUNCHES`` streamed: B a launch.
LANES_SWEPT = 0

#: (A dtype, x dtype) -> the kernel instance that takes them; y has x's dtype.
INSTANCES = {(torch.float32, torch.float32): "batched_gemv_f32",
             (torch.bfloat16, torch.float32): "batched_gemv_bf16",
             (torch.float64, torch.float64): "batched_gemv_f64",
             (torch.float32, torch.float64): "batched_gemv_f32_f64"}


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
    """What the CUDA kernel takes beyond ``_check``: a pair of ``INSTANCES``
    (f32 A and x, bf16 A and f32 x, f64 A and x, f32 A and f64 x), both
    contiguous (at any storage offset)."""
    if (A.dtype, x.dtype) not in INSTANCES:
        if A.dtype == torch.bfloat16 and x.dtype == torch.float64:
            raise TypeError(f"the CUDA kernel has no instance for {A.dtype} A with float64 x: "
                            "that pair is on no path (ROADMAP, queue 2)")
        raise TypeError(f"the CUDA kernel takes f32 A and x, bf16 A with f32 x, f64 A and "
                        f"x, or f32 A with f64 x, not {A.dtype} A with {x.dtype} x")
    if not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous A and x")


def batched_gemv(A, x):
    """y[b] = A[b] @ x[b] for A (B, n, n) and x (B, n) -> (B, n).

    On CUDA: (A, x) is a pair of ``INSTANCES``, both contiguous, the kernel
    runs on the current stream and y has x's dtype.  On the CPU: the plain
    version, in any floating dtype.
    """
    _check(A, x)
    if A.device.type == "cpu":
        return batched_gemv_reference(A, x)
    if A.device.type != "cuda":
        raise ValueError(f"batched_gemv runs on cuda or cpu, not {A.device}")
    _check_kernel_operands(A, x)
    B, n = x.shape
    y = torch.empty((B, n), dtype=x.dtype, device=A.device)
    if B == 0 or n == 0:
        return y
    kernels.launch(INSTANCES[A.dtype, x.dtype], A.device, A.data_ptr(), x.data_ptr(),
                   y.data_ptr(), B, n)
    kernels.count(_count, A.dtype, x.dtype, B)
    return y


def _count(a_dtype, x_dtype, B):
    """Count one launch of the instance for (a_dtype, x_dtype) over B lanes."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_F64, LAUNCHES_F32_F64, LANES_SWEPT
    LAUNCHES += 1
    LANES_SWEPT += B
    if a_dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    elif a_dtype == torch.float64:
        LAUNCHES_F64 += 1
    elif x_dtype == torch.float64:
        LAUNCHES_F32_F64 += 1

