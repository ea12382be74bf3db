#!/usr/bin/env python3
"""Time the symv kernel at every row-slice count S on one card, beside
the launch floor.

1. One problem: for each (n, tile) of ``SHAPES`` (f32 tiles packed from
   A = G + G^T) the script checks every S against the plain f64 version
   (rel err < 1e-5) and then times ``symv.symv_packed`` at S = 1, 2, 4, ...
   up to slices of 32 rows in ``ROUNDS`` interleaved rounds, device-only
   (``utils.benchmark.device_ms``; the order of S reversed every other
   round), with the launch floor (an in-place add on a one-element tensor)
   and the floor of two such launches in each round: their difference is
   what a second launch costs, the most that folding the kernel's second
   pass into its first could save.
2. Few problems: ``batched_symv_packed`` at n = 1024, tile 256, for each B
   of ``BATCHES`` and S = 1 ... 8, the median of ``ROUNDS`` readings.

It prints the median time of each S, its ratio to S = 1, and which S
``symv.row_slices`` picks on this card.

Run:  python3 tools/symv_slices.py      (one CUDA GPU, nvcc for sm_90a)
"""
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccqppy_tpu_torch.ops import symv  # noqa: E402
from ccqppy_tpu_torch.utils.benchmark import device_ms  # noqa: E402

SHAPES = ((1024, 256), (512, 128), (1024, 512))
BATCHES = (2, 4, 8, 13, 16, 32)
BATCH_SLICES = (1, 2, 4, 8)
ROUNDS = 6


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.zeros(1, device=dev)
    sms = symv.sm_count(0)
    for n, tile in SHAPES:
        G = torch.randn((1, n, n), generator=gen, device=dev)
        Ap = symv.pack_symmetric(G + G.mT, tile)[0]
        x = torch.randn(n, generator=gen, device=dev)
        ref = symv.symv_packed_reference(Ap.double(), x.double(), n)
        counts = [S for S in (2 ** k for k in range(12)) if S <= tile // symv.SLICE_ROWS_STEP]
        for S in counts:
            y = symv.symv_packed(Ap, x, slices=S)
            err = float((y.double() - ref).abs().max() / ref.abs().max())
            if not err < 1e-5:
                raise RuntimeError(f"n={n} tile={tile} S={S}: rel err {err}")
        times = {S: [] for S in counts}
        floor, floor2 = [], []
        for k in range(ROUNDS):
            for S in (counts if k % 2 == 0 else counts[::-1]):
                times[S].append(device_ms(lambda: symv.symv_packed(Ap, x, slices=S)))
            floor.append(device_ms(lambda: one.add_(1)))
            floor2.append(device_ms(lambda: (one.add_(1), one.add_(1))))
        T = symv.num_tiles(n // tile)
        ms = {S: statistics.median(t) for S, t in times.items()}
        print(f"symv_packed (1, {n}, {tile}), T={T}, {ROUNDS} rounds, device-only: launch floor "
              f"{statistics.median(floor):.4f} ms (two launches {statistics.median(floor2):.4f} "
              f"ms); row_slices picks S={symv.row_slices(1, T, tile, sms)} on {sms} SMs")
        for S in counts:
            print(f"  S={S:4d} ({T * S:5d} blocks): {ms[S]:.4f} ms, {ms[S] / ms[1]:.4f} of S=1")
    n, tile = 1024, 256
    T = symv.num_tiles(n // tile)
    for B in BATCHES:
        G = torch.randn((B, n, n), generator=gen, device=dev)
        Ap = symv.pack_symmetric(G + G.mT, tile)
        x = torch.randn((B, n), generator=gen, device=dev)
        del G
        ms = {S: statistics.median(device_ms(lambda: symv.batched_symv_packed(Ap, x, slices=S))
                                   for _ in range(ROUNDS))
              for S in BATCH_SLICES}
        print(f"batched_symv_packed (B={B}, {n}, {tile}), {B * T} tiles: row_slices picks "
              f"S={symv.row_slices(B, T, tile, sms)}; "
              + ", ".join(f"S={S} {v:.4f} ms" for S, v in ms.items()))
    print(smi)


if __name__ == "__main__":
    main()
