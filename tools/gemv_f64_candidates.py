#!/usr/bin/env python3
"""Time geometries of the GEMV kernel's f64 instance against ``torch.bmm``.

Each candidate is ``csrc/batched_gemv.cu`` with its work-unit geometry
changed: rows a unit (``R``), consumer warps (``CONSUMERS``) and the bytes
of a row in a column tile (``cmax``).  Each is built by ``nvcc`` into a
library of its own (all builds at once) and loaded with ``ctypes``; only
its f64 instance is used.  The script checks that every candidate gives
bitwise the y of the first (the order of the sums does not depend on the
geometry) and is within ``GEMV_F64_TOL`` of the plain f64 version, then
times each at the (B, n) of ``SHAPES`` in ``ROUNDS`` interleaved rounds,
device-only (``utils.benchmark.device_ms``): every candidate, then
``torch.bmm`` f64 (cuBLAS), the candidates' order reversed every other
round.  It prints, per shape and candidate, the median time, GB/s of A and
the min / median / max of the per-round ratio candidate / ``torch.bmm``.

Run:  python3 tools/gemv_f64_candidates.py      (one CUDA GPU, nvcc for sm_90a)
"""
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccqppy_tpu_torch.ops import gemv, kernels  # noqa: E402
from ccqppy_tpu_torch.utils.benchmark import device_ms  # noqa: E402

# (rows a unit, consumer warps, tile bytes): the source's own geometry; 8
# whole rows of up to 8 KB a unit with 2 rows a warp; the same with 1 row a
# warp.
CANDIDATES = ((16, 8, 4096), (8, 4, 8192), (8, 8, 8192))
SHAPES = ((64, 1000), (1024, 1000))
CHECK_SHAPES = ((1, 1), (3, 33), (3, 999), (2, 1024), (3, 1025), (1, 2049))
ROUNDS = 10
GEMV_F64_TOL = 1e-13
# The source lines that set the geometry, each with the text of a candidate
# (the tile bytes of 8-byte elements only: the f32 and bf16 instances, not
# timed here, keep theirs and so still fit three stages).
GEOMETRY = ((re.compile(r"constexpr int R = \d+;"), "constexpr int R = {R};"),
            (re.compile(r"constexpr int CONSUMERS = \d+;"), "constexpr int CONSUMERS = {W};"),
            (re.compile(r"return (\d+) / sizeof\(T\);"),
             r"return (sizeof(T) == 8 ? {tile} : \1) / sizeof(T);"))


def build_all():
    """One library per candidate, all ``nvcc`` runs started together."""
    src = (kernels.CSRC_DIR / "batched_gemv.cu").read_text()
    for pattern, _ in GEOMETRY:
        if len(pattern.findall(src)) != 1:
            raise RuntimeError(f"batched_gemv.cu has no single line {pattern.pattern}")
    out_dir = kernels.BUILD_DIR / "f64_candidates"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for R, W, tile in CANDIDATES:
        cu = out_dir / f"gemv_f64_{R}_{W}_{tile}.cu"
        text = src
        for pattern, line in GEOMETRY:
            text = pattern.sub(line.format(R=R, W=W, tile=tile), text)
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs.append((lib, subprocess.Popen(kernels.nvcc_command(lib, [cu], kernels.nvcc_path()),
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
    libs = []
    for (R, W, tile), (lib, proc) in zip(CANDIDATES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ({R}, {W}, {tile}):\n{err}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({R}, {W}, {tile}):", line.strip())
        fn = ctypes.CDLL(str(lib)).batched_gemv_f64
        fn.argtypes = kernels.SIGNATURES["batched_gemv_f64"]
        fn.restype = ctypes.c_int
        libs.append(fn)
    return libs


def launch(fn, A, x):
    y = torch.empty_like(x)
    err = fn(A.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"candidate launch failed with CUDA error {err}")
    return y


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    fns = build_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, n in CHECK_SHAPES + SHAPES:
        A = torch.randn((B, n, n), generator=gen, device=dev, dtype=torch.float64)
        x = torch.randn((B, n), generator=gen, device=dev, dtype=torch.float64)
        ref = gemv.batched_gemv_reference(A, x)
        ys = [launch(fn, A, x) for fn in fns]
        torch.cuda.synchronize()
        for (R, W, tile), y in zip(CANDIDATES, ys):
            err = float((y - ref).abs().max() / ref.abs().max())
            if not err <= GEMV_F64_TOL:
                raise RuntimeError(f"({R}, {W}, {tile}) at (B={B}, n={n}): rel err {err}")
            if not torch.equal(y.view(torch.int64), ys[0].view(torch.int64)):
                raise RuntimeError(f"({R}, {W}, {tile}) at (B={B}, n={n}) is not bitwise "
                                   f"the first candidate's y")
    print(f"candidates {CANDIDATES}: bitwise equal y, rel err <= {GEMV_F64_TOL} at "
          f"{CHECK_SHAPES + SHAPES}")
    for B, n in SHAPES:
        A = torch.randn((B, n, n), generator=gen, device=dev, dtype=torch.float64)
        x = torch.randn((B, n), generator=gen, device=dev, dtype=torch.float64)
        xc = x.unsqueeze(-1)
        times = [[] for _ in fns]
        lib = []
        for k in range(ROUNDS):
            order = list(range(len(fns))) if k % 2 == 0 else list(range(len(fns)))[::-1]
            for c in order:
                times[c].append(device_ms(lambda: launch(fns[c], A, x)))
            lib.append(device_ms(lambda: torch.bmm(A, xc)))
        nbytes = A.numel() * 8
        lib_ms = statistics.median(lib)
        print(f"(B={B}, n={n}) f64, {ROUNDS} rounds, device-only: torch.bmm {lib_ms:.4f} ms "
              f"({nbytes / lib_ms / 1e6:.1f} GB/s)")
        for (R, W, tile), t in zip(CANDIDATES, times):
            ratios = sorted(a / b for a, b in zip(t, lib))
            ms = statistics.median(t)
            print(f"  ({R}, {W}, {tile}): {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s); "
                  f"/ torch.bmm min {ratios[0]:.4f}, median {statistics.median(ratios):.4f}, "
                  f"max {ratios[-1]:.4f}")
        del A, x, xc
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
