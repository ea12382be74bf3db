"""Build, load and launch the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, at first use, and loaded
with ``ctypes``.  The library lands in ``build/ccqppy_tpu_torch/`` beside
the package (a directory git ignores); its name carries a hash of the
sources, the headers beside them (``*.cuh``) and the flags, so an unchanged
tree is built once.  Nothing is built or loaded when this module is
imported.

``launch`` calls an entry point on the current stream; ``count`` and
``graph_capture`` keep the wrappers' launch counters true under CUDA graph
capture, where a recorded launch runs once each replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ccqppy_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as c_int64.
_P, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# apgd_sc_step_*: the state's twelve pointers (A v, b, x, y, v, res, mv, it,
# done, verifying, L, beta), the set's parameters, then (batch, n, tol,
# budget, restart, stream).
_STEP = (_P,) * 12
_STEP_TAIL = (_I64, _I64, _F64, _I64, _I64, _P)
# mprgp_step_lorentz_*: the state's seventeen pointers (A v, b, x, g, p,
# x_prev, g_prev, psi, v, alpha_bb, res, mv, it, done, pending, verifying,
# prop), mu and its stride, d, then (batch, n, tol, budget, gamma^2, tiny,
# mode, threads, cluster, stream).
_MPRGP = ((_P,) * 17 + (_P, _I64, _I64, _I64, _I64, _F64, _I64, _F64, _F64, _I64, _I64, _I64,
                        _P))
# pcg_step_box_*: the state's eleven pointers (A p, x, g, m, p, rr, res, mv,
# it, done, active), Jacobi's 1 / diag A and its stride, the bounds and
# their strides, gd, tiny, then (batch, n, tol, budget, threads, stream).
_PCG = (_P,) * 11 + (_P, _I64, _P, _I64, _P, _I64, _F64, _F64, _I64, _I64, _F64, _I64, _I64, _P)
SIGNATURES = {
    "batched_gemv_f32": (_P, _P, _P, _I64, _I64, _P),
    "batched_gemv_bf16": (_P, _P, _P, _I64, _I64, _P),
    "batched_gemv_f64": (_P, _P, _P, _I64, _I64, _P),
    "batched_gemv_f32_f64": (_P, _P, _P, _I64, _I64, _P),
    "batched_symv_packed_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "batched_symv_full_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "apgd_sc_step_lorentz_f32": (*_STEP, _P, _I64, _I64, *_STEP_TAIL),
    "apgd_sc_step_lorentz_f64": (*_STEP, _P, _I64, _I64, *_STEP_TAIL),
    "apgd_sc_step_box_f32": (*_STEP, _P, _I64, _P, _I64, _F64, *_STEP_TAIL),
    "apgd_sc_step_box_f64": (*_STEP, _P, _I64, _P, _I64, _F64, *_STEP_TAIL),
    "mprgp_step_lorentz_f32": _MPRGP,
    "mprgp_step_lorentz_f64": _MPRGP,
    "pcg_step_box_f32": _PCG,
    "pcg_step_box_f64": _PCG,
    # loop_flag: done, batch, out.
    "loop_flag": (_P, _I64, _P, _P),
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def nvcc_command(out, srcs, nvcc="nvcc"):
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


def library_path(srcs):
    """The library built from ``srcs``: its name hashes the flags, the
    sources and every header (``*.cuh``) in their directories, which the
    sources may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = {hdr for src in srcs for hdr in Path(src).parent.glob("*.cuh")}
    for src in [*srcs, *sorted(headers)]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libccqppy_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile the sources unless a library of the same hash exists.
    Returns (path, nvcc's stderr or "" when nothing was compiled)."""
    srcs = sources()
    out = library_path(srcs)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename: a concurrent process never loads
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(tmp, srcs, nvcc_path()),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr


@functools.cache
def load():
    """The loaded kernel library (built first if needed), with argtypes set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name, device, *args):
    """Call entry point ``name`` with ``args`` and the current stream of CUDA
    ``device``, under that device; a nonzero return is a ``RuntimeError``
    naming the entry point."""
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


#: The counts deferred by the CUDA graph capture in progress, or None.
_captured = None


def count(add, *args):
    """Count a launch that was made: ``add(*args)`` now, or, while a CUDA
    graph captures (``graph_capture``), once for each replay."""
    if _captured is None:
        add(*args)
    else:
        _captured.append((add, args))


@contextlib.contextmanager
def graph_capture():
    """Around a CUDA graph's capture: the launches recorded there run only
    when the graph replays, so they are not counted; the function yielded
    counts each of them once, for one replay."""
    global _captured
    _captured = taken = []
    try:
        yield lambda: [add(*args) for add, args in taken]
    finally:
        _captured = None
