"""What the GEMV's (f32 A, f64 x) instance moves: MPRGP's sweeps below f64
(f64 sums of an f32 stack, each loop sweep and each audit).  A launch
streams every lane of (B, n): it reads A in f32 and x in f64 once and
writes y in f64 once, ``n^2 x 4 + 2 n x 8`` bytes a lane, and takes
``2 n^2`` FLOPs a lane (f64 multiply-adds, far below the card's f64 rate:
bytes-bound)."""
import re

KERNEL = re.compile(r"batched_gemv_kernel<float,\s*double>")


def is_kernel(name):
    """True for the profiler's name of the (f32 A, f64 x) GEMV instance."""
    return KERNEL.search(name) is not None


def sweep_bytes(n, lanes):
    """Bytes ``lanes`` lane sweeps of the instance move at width n."""
    return float(lanes) * (4 * n * n + 16 * n)
