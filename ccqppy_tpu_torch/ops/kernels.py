"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, at first use, and loaded
with ``ctypes``.  The library lands in ``build/ccqppy_tpu_torch/`` beside
the package (a directory git ignores); its name carries a hash of the
sources and flags, so an unchanged tree is built once.  Nothing is built or
loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ccqppy_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as c_int64.
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    "batched_gemv_f32": (_P, _P, _P, _I64, _I64, _P),
    "batched_gemv_bf16": (_P, _P, _P, _I64, _I64, _P),
    "batched_symv_packed_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    "batched_symv_full_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
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
