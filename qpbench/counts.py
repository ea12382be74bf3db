"""The yardstick's arithmetic: what a GEMV sweep needs, and the card's peaks.

A sweep of one lane is ``y = A x`` with A (n, n): it reads A and x once and
writes y once, ``(n^2 + 2 n) x element`` bytes, and takes ``2 n^2`` FLOPs.
The sweeps a call needs are the lanes' reported matvecs plus the sweeps the
path leaves out of that count (an entry's ``UNCOUNTED_SWEEPS`` a lane), so
the work is what these inputs need, not what a batched loop sweeps in all.
A sweep of a bf16 copy of A counts its elements at two bytes.

One launch of the fused ``apgd_sc`` step runs every lane of (B, n).  A
live lane's plain step reads ``A v``, b, x and y and writes x, y and v:
seven vectors of n elements; its verifying step reads no y: six.  A done
lane reads x or y and writes v: two.  The set's own data (cone mu, box
bounds) is not counted.  Its ~40 operations an element bound it far below
its bytes.

The peaks are the published ones of the card's name (``peaks.json``).
"""
from __future__ import annotations

import json
from pathlib import Path

ELEMENT_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}
FLOPS_KEY = {"float32": "f32_flops_per_s", "float64": "f64_flops_per_s",
             "bfloat16": "bf16_flops_per_s"}
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def sweep_bytes(n, sweeps, dtype="float32"):
    """Bytes ``sweeps`` lane sweeps of an (n, n) operator move."""
    return float(sweeps) * (n * n + 2 * n) * ELEMENT_BYTES[dtype]


def sweep_flops(n, sweeps):
    return float(sweeps) * 2.0 * n * n


def sc_step_bytes(n, live, done, verifying=0, dtype="float32"):
    """Bytes the fused ``apgd_sc`` step moves over ``live`` lane-steps on
    lanes still running, ``verifying`` of them verifying steps, and ``done``
    lane-steps on lanes already done."""
    return float(7 * live - verifying + 2 * done) * n * ELEMENT_BYTES[dtype]


def peaks(kind):
    """The published peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def least_seconds(n, sweeps, dtype, peak):
    """The least time the card could take for the sweeps: (seconds, "bytes"
    or "flops", whichever bounds it)."""
    t_bytes = sweep_bytes(n, sweeps, dtype) / peak["hbm_bytes_per_s"]
    t_flops = sweep_flops(n, sweeps) / peak[FLOPS_KEY[dtype]]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
