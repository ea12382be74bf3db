"""A solver loop's test, whether any lane still runs, written by one launch
of ``csrc/loop_flag.cu``: the last node of a CUDA graph of a pass, so that
the host reads one number a pass and launches nothing for the test.  The
number may go to host memory that is pinned (the kernel writes it through
its mapped address), where the host reads it with no call into CUDA
(``models.base.host_flag``).  On a CPU tensor the plain version runs.
``LAUNCHES`` counts the launches that ran; one recorded while a CUDA graph
captures counts once a replay (``kernels.graph_capture``), as the GEMV's
do.
"""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.ops import kernels

#: Number of kernel launches in this process.
LAUNCHES = 0


def running(done, out):
    """``out[0] = any(~done)`` (1 or 0), for ``done`` a contiguous (B,) bool
    tensor and ``out`` one int64 on its device or, for ``done`` on a card,
    in pinned host memory."""
    if done.dtype != torch.bool or done.dim() != 1 or not done.is_contiguous():
        raise ValueError("done must be a contiguous (B,) bool tensor")
    pinned = done.is_cuda and out.device.type == "cpu" and out.is_pinned()
    if out.dtype != torch.int64 or out.numel() != 1 or not (out.device == done.device
                                                            or pinned):
        raise ValueError("out must be one int64 on done's device or in pinned host memory")
    if done.device.type == "cpu":
        out.copy_((~done).any())
        return
    kernels.launch("loop_flag", done.device, done.data_ptr(), done.shape[0], out.data_ptr())
    kernels.count(_count)


def _count():
    global LAUNCHES
    LAUNCHES += 1
