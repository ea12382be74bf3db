#!/usr/bin/env python3
"""Time the symv kernel against the kernel before row slices, in one call.

``OTHER_TREE`` is a checkout whose ``csrc/batched_symv.cu`` launcher takes
no slice count (the commit before row slices; its scratch is
(B, T, 2, tile)).  Its source is built by ``nvcc`` beside this tree's
library and loaded with ``ctypes``.  At each (B, n, tile) of ``SHAPES``
(packed tiles of A = G + G^T) the script checks that this tree's kernel
at one slice gives bitwise the older kernel's y, then times, device-only
(``utils.benchmark.device_ms``), the older kernel, this tree's at one
slice and this tree's at the slices ``symv.row_slices`` picks, in
``ROUNDS`` rounds whose order alternates (older first, then last).  It
prints the medians and the min / median / max of the per-round ratio of
each of this tree's readings to the older one.

Run:  python3 tools/symv_before_slices.py OTHER_TREE      (one CUDA GPU, nvcc)
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccqppy_tpu_torch.ops import kernels, symv  # noqa: E402
from ccqppy_tpu_torch.utils.benchmark import device_ms  # noqa: E402

# The packed mode's shape, and its lane 0 alone (mode (l)).
SHAPES = ((2048, 1024, 256), (1, 1024, 256))
ROUNDS = 6
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def build_before(tree):
    src = Path(tree) / "ccqppy_tpu_torch" / "csrc" / "batched_symv.cu"
    out = kernels.BUILD_DIR / "before_slices" / "libsymv_before.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(kernels.nvcc_command(out, [src], kernels.nvcc_path()),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).batched_symv_packed_f32
    fn.argtypes = (_P, _P, _P, _P, _I64, _I64, _I64, _P)
    fn.restype = ctypes.c_int
    return fn


def before(fn, Ap, x):
    B, T, tile, _ = Ap.shape
    n = x.shape[1]
    y = torch.empty_like(x)
    part = torch.empty((B, T, 2, tile), dtype=torch.float32, device=x.device)
    err = fn(Ap.data_ptr(), x.data_ptr(), y.data_ptr(), part.data_ptr(), B, n, tile,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the older kernel failed with CUDA error {err}")
    return y


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit("usage: symv_before_slices.py OTHER_TREE  (on a CUDA GPU)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    old = build_before(sys.argv[1])
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = symv.sm_count(0)
    for B, n, tile in SHAPES:
        Ap = torch.empty((B, symv.num_tiles(n // tile), tile, tile), device=dev)
        for i in range(0, B, 256):
            G = torch.randn((min(256, B - i), n, n), generator=gen, device=dev)
            Ap[i:i + 256] = symv.pack_symmetric(G + G.mT, tile)
        del G
        x = torch.randn((B, n), generator=gen, device=dev)
        S = symv.row_slices(B, Ap.shape[1], tile, sms)
        y_old = before(old, Ap, x)
        y_one = symv.batched_symv_packed(Ap, x, slices=1)
        if not torch.equal(y_old.view(torch.int32), y_one.view(torch.int32)):
            raise RuntimeError(f"(B={B}, n={n}, tile={tile}): one slice is not bitwise the "
                               f"older kernel's y")
        runs = {"before": lambda: before(old, Ap, x),
                "S=1": lambda: symv.batched_symv_packed(Ap, x, slices=1),
                f"S={S}": lambda: symv.batched_symv_packed(Ap, x, slices=S)}
        times = {k: [] for k in runs}
        for k in range(ROUNDS):
            for name in (list(runs) if k % 2 == 0 else list(runs)[::-1]):
                times[name].append(device_ms(runs[name]))
        line = [f"symv packed (B={B}, n={n}, tile={tile}), {ROUNDS} rounds, device-only, "
                f"S=1 bitwise the older kernel's y: before {statistics.median(times['before']):.4f} ms"]
        for name in list(runs)[1:]:
            r = sorted(a / b for a, b in zip(times[name], times["before"]))
            line.append(f"{name} {statistics.median(times[name]):.4f} ms, / before min {r[0]:.4f}, "
                        f"median {statistics.median(r):.4f}, max {r[-1]:.4f}")
        print("; ".join(line))
        del Ap, x
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
