"""The least time of the profiled calls' launches of the GEMV's (f32 A, f64
x) instance (``_gemv_f32_f64_counts``: every lane of the mix's batch a
launch, bytes-bound at the card's HBM rate) over those launches' device
time, in %.  None where the trace holds no such launch, or where its
launches are not the program's (the entry's ``gemv_launches_f32_f64``
gain over the profiled calls)."""
from pathlib import Path

from qpbench import counts
from qpbench.registry import load_module

_counts = load_module(Path(__file__).with_name("_gemv_f32_f64_counts.py"),
                      "qpbench_gemv_f32_f64_counts")


def read(rec):
    peak = counts.peaks(rec.device_kind)
    if peak is None or rec.trace is None or rec.profiled is None:
        return None
    names = [k for k in rec.trace.kernel_s if _counts.is_kernel(k)]
    seconds = sum(rec.trace.kernel_s[k] for k in names)
    if seconds <= 0:
        return None
    launches = sum(rec.trace.kernel_launches[k] for k in names)
    if (rec.profiled.counters or {}).get("gemv_launches_f32_f64") != launches:
        return None
    moved = _counts.sweep_bytes(int(rec.config["n"]), launches * int(rec.mix["lanes"]))
    return 100.0 * moved / peak["hbm_bytes_per_s"] / seconds
