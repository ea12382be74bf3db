"""What the benchmark entry and the studies share.

The JAX scripts each write these inline: the per-call perturbation of the
right-hand sides, the pipelined measurement (``bench.py:127-145`` there),
the independent residual audit, the command line and the result file.
Here they are written once:

* ``perturbed(base, tag, rep)``: ``base`` plus absolute normal noise (1e-3
  by default) from a ``torch.Generator`` on ``base``'s device seeded from
  ``(tag, rep)``, so a rep's right-hand side can be drawn again;
* ``pipelined(run, base, tag, depth, implied_bytes, check)``: ``depth``
  calls back to back and one synchronise, the min of 2 trials; every
  trial's results are copied to the host and checked outside the clock,
  and a wall implying more than twice the card's memory rate
  (``utils.benchmark.PEAK_HBM_BYTES_PER_S``) raises;
* ``audit_residual``: the true Eq. 25 residual of every lane in f64 through
  the plain GEMV (never the kernel), in lane chunks;
* ``resolve_device`` (CUDA unless the caller asks for the CPU; no
  fallback), ``card_stamp`` (the card's name and the ``nvidia-smi`` line
  of its name and power limit, written into every result), ``parser``
  (``--device``, ``--out``) and ``write_json``.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.ops import gemv, kernels
from ccqppy_tpu_torch.utils.benchmark import PEAK_HBM_BYTES_PER_S, materialize, synchronize

#: Where results go unless ``--out`` says otherwise (``build/`` is ignored by git).
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "bench_results"
NOISE = 1e-3          # absolute perturbation of b a call (|b| ~ 1e3 at n = 1000)
PIPELINE_TRIALS = 2   # pipelined: the min over this many trials
AUDIT_LANES = 256     # lanes of an f64 copy the audit holds at once
GD = 1e-6             # the Eq. 25 residual's gradient step (SolverConfig.gd)


@functools.cache
def _warm_kernels(device):
    """Build and load the kernels and launch the GEMV once on ``device``, so
    ``nvcc`` and the first launch land before any clock; once a process."""
    kernels.load()
    gemv.batched_gemv(torch.zeros((1, 8, 8), device=device), torch.zeros((1, 8), device=device))
    torch.cuda.synchronize(device)


def resolve_device(device):
    """``device`` as a ``torch.device``; a CUDA one gets its index, TF32 off
    (exact f32 sweeps decide convergence) and the kernels warm
    (``_warm_kernels``).  A CUDA device where there is none raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"the benchmarks run on cuda or cpu, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _warm_kernels(device)
    return device


def card_stamp(device):
    """What ran the numbers: the device, its name, and on CUDA the
    ``nvidia-smi`` name and power limit of every card, as the tool prints
    them."""
    if device.type != "cuda":
        return {"device": "cpu", "name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return {"device": str(device), "name": torch.cuda.get_device_name(device),
            "nvidia_smi": "; ".join(smi.splitlines())}


def seed_of(tag, rep):
    """The generator seed of ``(tag, rep)``; ``rep`` counts from -1 (the
    warm-up of ``timed_run``)."""
    return 1_000_003 * int(tag) + int(rep) + 1


def perturbed(base, tag, rep, scale=NOISE):
    """``base`` plus ``scale`` N(0, 1) noise drawn on ``base``'s device from
    the seed of ``(tag, rep)``.  Normal noise, not a scalar shift: a shift
    of 1e-3 is below the f32 ulp of the largest entries of b and would
    leave them unchanged."""
    gen = torch.Generator(device=base.device).manual_seed(seed_of(tag, rep))
    return base + scale * torch.randn(base.shape, generator=gen, dtype=base.dtype,
                                      device=base.device)


def pipelined(run, base, tag, depth, implied_bytes, check, scale=NOISE):
    """Steady-state wall per call: ``depth`` calls of ``run`` on freshly
    perturbed right-hand sides enqueued back to back, one synchronise, the
    min over ``PIPELINE_TRIALS`` trials (trial t draws with tag ``tag + t``).
    Every trial's results are copied to the host and ``check(result, b)``
    runs on each, outside the clock.  Returns (wall, the last trial's
    results, their right-hand sides)."""
    floor = float(implied_bytes) / (2 * PEAK_HBM_BYTES_PER_S)
    walls = []
    for trial in range(PIPELINE_TRIALS):
        bs = [perturbed(base, tag + trial, i, scale) for i in range(depth)]
        synchronize(bs)
        t0 = time.perf_counter()
        outs = [run(b) for b in bs]
        synchronize(outs)
        wall = (time.perf_counter() - t0) / depth
        if wall < floor:
            raise RuntimeError(f"pipelined wall {wall:.4g} s implies more than twice the "
                               f"device-memory rate for {implied_bytes:.3g} bytes: the fence leaks")
        walls.append(wall)
        for r, b in zip(outs, bs):
            materialize(r)
            check(r, b)
    return min(walls), outs, bs


def f64_copy(proj):
    """An f64 copy of a projection, for the audit (``proj`` is left as it is)."""
    return copy.deepcopy(proj).double()


def audit_residual(As, b, x, proj64):
    """True Eq. 25 residual of every lane, (B,) f64: ``A x + b`` by the
    plain GEMV in f64 (never the kernel), ``AUDIT_LANES`` lanes at a time,
    and the f64 set ``proj64``."""
    x64 = x.double()
    Ax = torch.cat([gemv.batched_gemv_reference(As[i:i + AUDIT_LANES].double(),
                                                x64[i:i + AUDIT_LANES])
                    for i in range(0, As.shape[0], AUDIT_LANES)])
    return pg_residual(proj64, x64, Ax + b.double(), GD)


def p50(t):
    """The median of a tensor's values as numpy takes it (the mean of the
    two middle values of an even count), as a float."""
    return float(np.median(t.detach().cpu().numpy()))


def require_converged(r, what):
    conv = float(r.converged.double().mean())
    if conv != 1.0:
        raise RuntimeError(f"{what}: convergence {conv} != 1.0")


def parser(description):
    """The arguments every entry takes: ``--device`` and ``--out``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help=f"directory of the JSON result (default {DEFAULT_OUT})")
    return ap


def write_json(out, name, payload):
    """Write ``payload`` to ``out/name`` and return the path."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / name
    path.write_text(json.dumps(payload, indent=1))
    return path
