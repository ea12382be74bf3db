"""16,384 independent n=1000 box QPs, streamed through one card in chunks.

Counterpart of the JAX package's ``benchmarks/benchmark_ensemble_16k.py``
(BASELINE.json config #4).  The stacked Hessians of the whole ensemble are
64 GB in f32, so one card streams it in chunks of 1024 (4.1 GB each, plus a
transient G of 1 GB a 256-lane piece while a chunk is drawn).  Chunk k is
drawn on the device from its own generator, seeded from (seed, k).  The box
is [-1, 1], tol 2e-5, PCG with a 500-matvec budget.

* **Fenced pass** (2 chunks, after one warm-up chunk): generation and
  solve each closed by a synchronise, PCG from x = 0, giving the split
  ``fenced_gen_s_per_chunk`` / ``fenced_solve_s_per_chunk``; each chunk's
  solutions are audited in f64 outside the clock (``fenced_true_residual_max``,
  beside the JAX keys).
* **Streamed pass** (the whole ensemble, 2 timed reps): a host loop over
  chunks that draws a chunk, solves it from the Jacobi start and keeps only
  its lanes' ``converged``, matvecs and a checksum of x on the device, with
  no fence between generation and solve; everything is read once at the
  end.  A chunk's stack is freed before the next is drawn.

The JAX script's streamed pass is one jit over chunks, which saves a
remote dispatch cost per chunk.  The port has no dispatch cost to amortise,
and its solver reads its lanes' state on the host every iteration anyway,
so ``stream_speedup_vs_fenced`` measures what the fences, the x = 0 start
against the Jacobi start and the per-chunk copies to the host cost, not a
saved dispatch.  ``fenced_solve_per_s`` counts the fenced pass's solve phase,
``end_to_end_per_s`` the streamed pass with all generation.

Run:  python -m ccqppy_tpu_torch.benchmarks.benchmark_ensemble_16k
      [--device cuda|cpu] [--out DIR] [--total 16384] [--chunk 1024] [-n 1000]
Writes ``ensemble_16k.json``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ccqppy_tpu_torch.benchmarks import common
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import solve_batched
from ccqppy_tpu_torch.utils.benchmark import materialize, synchronize, timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

N = 1000
TOL = 2e-5
BUDGET = 500
TOTAL = 16384
CHUNK = 1024
SEED = 0
STREAM_REPS = 2
SWEEPS_FLOOR = 10  # least sweeps a lane, for the timing guard


def draw_chunk(seed, k, chunk, n, dtype, device):
    """Chunk ``k`` of the ensemble of ``seed``: (A (chunk, n, n), b (chunk, n))."""
    gen = torch.Generator(device=device).manual_seed(common.seed_of(seed, k))
    A, b, _ = random_qp_batch(gen, chunk, n, dtype, diag_boost=1.0, chunk=256)
    return A, b


def solve_chunk(A, b, proj, cfg):
    """The streamed pass's solve of one chunk: PCG from the Jacobi start."""
    x0 = torch.clamp(-b / A.diagonal(dim1=-2, dim2=-1), -1.0, 1.0)
    return solve_batched("pcg", A, b, x0=x0, proj=proj, config=cfg)


def stream(seed, n_chunks, chunk, n, proj, cfg, dtype, device):
    """Draw and solve every chunk; returns (converged, matvecs, sum |x| a
    lane), each (n_chunks, chunk), left on the device."""
    conv, mv, xsum = [], [], []
    for k in range(n_chunks):
        A, b = draw_chunk(seed, k, chunk, n, dtype, device)
        r = solve_chunk(A, b, proj, cfg)
        conv.append(r.converged)
        mv.append(r.matvecs)
        xsum.append(r.x.abs().sum(dim=-1))
        del A, b, r
    return torch.stack(conv), torch.stack(mv), torch.stack(xsum)


def main(total=TOTAL, chunk=CHUNK, n=N, seed=SEED, device="cuda", dtype=torch.float32,
         out=common.DEFAULT_OUT):
    """Both passes; returns the JSON payload (also written to ``out``)."""
    device = common.resolve_device(device)
    total, chunk = int(total), int(chunk)
    n_chunks = total // chunk
    proj = box(-torch.ones(n), torch.ones(n), dtype=dtype, device=device)
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)

    proj64 = common.f64_copy(proj)

    def fenced(k):
        """(generation s, solve s, the solve's audited max residual) of chunk k."""
        t0 = time.perf_counter()
        A, b = draw_chunk(seed, k, chunk, n, dtype, device)
        synchronize((A, b))
        t1 = time.perf_counter()
        r = solve_batched("pcg", A, b, proj=proj, config=cfg)
        materialize(r)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, float(common.audit_residual(A, b, r.x, proj64).max())

    fenced(0)   # warm-up
    split = [fenced(k) for k in range(min(2, n_chunks))]
    gen_s = float(np.mean([s[0] for s in split]))
    solve_s = float(np.mean([s[1] for s in split]))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    res = timed_run(lambda s: stream(s, n_chunks, chunk, n, proj, cfg, dtype, device),
                    reps=STREAM_REPS, warmup=False,
                    make_args=lambda rep: (common.seed_of(seed + 1, rep),),
                    implied_bytes=float(total) * SWEEPS_FLOOR * n * n * torch.finfo(dtype).bits / 8)
    conv, mv, xsum = (t.cpu() for t in res.result)
    if xsum.shape != (n_chunks, chunk) or not bool((xsum > 0).all()):
        raise RuntimeError(f"streamed pass: checksums {tuple(xsum.shape)}, min {float(xsum.min())}")
    row = {
        "total_problems": total, "n": n, "chunk": chunk, "tol": TOL,
        "fenced_gen_s_per_chunk": gen_s,
        "fenced_solve_s_per_chunk": solve_s,
        "fenced_solve_per_s": chunk / solve_s,
        "fenced_true_residual_max": max(s[2] for s in split),
        "stream_s": res.wall_s,
        "end_to_end_per_s": total / res.wall_s,
        "stream_speedup_vs_fenced": (gen_s + solve_s) * n_chunks / res.wall_s,
        "convergence_rate": float(conv.double().mean()),
        "matvecs_median": int(np.median(mv.numpy())),
        "backend": device.type,
        "card": common.card_stamp(device),
    }
    print(row)
    common.write_json(out, "ensemble_16k.json", row)
    return row


def cli(argv=None):
    ap = common.parser("16k independent box QPs streamed through one card.")
    ap.add_argument("--total", type=int, default=TOTAL)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("-n", type=int, default=N)
    a = ap.parse_args(argv)
    return main(a.total, a.chunk, a.n, device=a.device, out=a.out)


if __name__ == "__main__":
    cli()
