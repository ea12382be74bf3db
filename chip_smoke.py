#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU and check it.

The main path is the batched 1000-dim box-QP workload: B independent QPs
with ``A = G G^T + n I`` (G standard normal), ``b = -A x_uncon``
(x_uncon ~ U(-1, 1)), box [-1, 1], tol 2e-5, a 500-matvec budget, and
right-hand sides perturbed by 1e-3 N(0, 1) per call.  Two modes:

* iterative (B=2048): Jacobi warm start ``clip(-b / diag A, -1, 1)``, then
  verified PCG with fused straggler compaction (phase 1 at 17 matvecs, a
  256-lane bucket);
* direct serving (B=1024): a one-time batched Cholesky inverse, then per
  call the projected inverse apply, a verification sweep and a compacted
  PCG polish (phase 1 at 3 matvecs, a 64-lane bucket).

Steps: build the CUDA kernels from ``ccqppy_tpu_torch/csrc``; hold each
kernel against its plain PyTorch version on the card; run both modes at
full width, audit every lane's true residual with the plain f64 GEMV, and
check that the kernel carried the path.  Any failed check raises, so the
exit code is non-zero.  The last line of standard output is one JSON
object naming the device.

Run:  python3 chip_smoke.py      (needs one CUDA GPU, nvcc for sm_90a)
"""
import json
import statistics
import subprocess
import time

import torch

from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.models.direct import solve_direct_batched, spd_inverse_batch
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.ops import gemv, kernels
from ccqppy_tpu_torch.ops.projections import box
from ccqppy_tpu_torch.parallel import solve_batched_fused_compact
from ccqppy_tpu_torch.utils.benchmark import dense_sweep_bytes, timed_run
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

N = 1000
TOL = 2e-5
BUDGET = 500
SEED = 0
NOISE = 1e-3

B_ITER = 2048
PHASE1 = 17        # p50 sweep count + the verification sweep
BUCKET = 256

B_DIRECT = 1024    # As and A^-1 both resident
PHASE1_DIRECT = 3
BUCKET_DIRECT = 64

REPS = 3           # timed reps per mode
KERNEL_REPS = 25   # timed launches per kernel measurement

GEMV_F32_TOL = 1e-5    # max|y - y_ref| / max|y_ref| against the f64 plain version
GEMV_BF16_TOL = 2e-2   # bf16 A against the f64 GEMV of the f32 A (quantization)
GEMV_BF16_PLAIN_TOL = 1e-5  # bf16 kernel against the plain bf16 version


def require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def jacobi_x0(diag, b):
    return torch.clamp(-b / diag, -1.0, 1.0)


def run_iterative(As, b, diag, proj, cfg):
    """One call of the iterative mode."""
    return solve_batched_fused_compact(
        "pcg", As, b, PHASE1, x0=jacobi_x0(diag, b), proj=proj, config=cfg,
        bucket=BUCKET, host_fallback=False)


def run_direct(Ainv, As, b, proj, cfg):
    """One call of the direct serving mode."""
    return solve_direct_batched(Ainv, As, b, proj, cfg, phase1=PHASE1_DIRECT,
                                bucket=BUCKET_DIRECT, host_fallback=False)


def gemv_f64(A, x, chunk=256):
    """Plain GEMV in f64, in lane chunks to bound the f64 copy of A."""
    return torch.cat([gemv.batched_gemv_reference(A[i:i + chunk].double(),
                                                  x[i:i + chunk].double())
                      for i in range(0, A.shape[0], chunk)])


def audit_residual(As, b, x):
    """True Eq. 25 residual of every lane in f64, independent of the kernel."""
    proj64 = box(-torch.ones(N), torch.ones(N), dtype=torch.float64,
                 device=x.device)
    g = gemv_f64(As, x) + b.double()
    return pg_residual(proj64, x.double(), g, 1e-6)


def time_ms(fn, reps=KERNEL_REPS, warmup=3):
    """Median device time of ``fn`` in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(y, ref):
    return float((y.double() - ref).abs().max() / ref.abs().max())


def check_kernels(gen, dev):
    """Kernel against plain version on the card; returns the measurements."""
    before = gemv.LAUNCHES
    for B, n in ((3, 999), (3, 37), (BUCKET, N)):
        A = torch.randn((B, n, n), generator=gen, device=dev)
        x = torch.randn((B, n), generator=gen, device=dev)
        err = rel_err(gemv.batched_gemv(A, x), gemv_f64(A, x))
        print(f"gemv f32 B={B} n={n}: rel err {err:.3e}")
        require(err < GEMV_F32_TOL, f"f32 gemv (B={B}, n={n}) rel err {err}")
        Ab = A.to(torch.bfloat16)
        err = rel_err(gemv.batched_gemv(Ab, x), gemv.batched_gemv_reference(Ab, x).double())
        print(f"gemv bf16 B={B} n={n}: rel err vs plain bf16 {err:.3e}")
        require(err < GEMV_BF16_PLAIN_TOL, f"bf16 gemv (B={B}, n={n}) rel err {err}")

    B, n = B_ITER, N
    A = torch.randn((B, n, n), generator=gen, device=dev)
    x = torch.randn((B, n), generator=gen, device=dev)
    ref = gemv_f64(A, x)
    y = gemv.batched_gemv(A, x)
    f32_err = rel_err(y, ref)
    f32_abs = float((y.double() - ref).abs().max())
    print(f"gemv f32 B={B} n={n}: rel err {f32_err:.3e}, max abs err {f32_abs:.3e}")
    require(f32_err < GEMV_F32_TOL, f"f32 gemv rel err {f32_err}")
    Ab = A.to(torch.bfloat16)
    bf16_err = rel_err(gemv.batched_gemv(Ab, x), ref)
    bf16_plain_err = rel_err(gemv.batched_gemv(Ab, x),
                             gemv.batched_gemv_reference(Ab, x).double())
    print(f"gemv bf16 B={B} n={n}: rel err vs f64 of f32 A {bf16_err:.3e}, "
          f"vs plain bf16 {bf16_plain_err:.3e}")
    require(bf16_err < GEMV_BF16_TOL, f"bf16 gemv rel err {bf16_err}")
    require(bf16_plain_err < GEMV_BF16_PLAIN_TOL, f"bf16 gemv vs plain {bf16_plain_err}")
    del ref
    require(gemv.LAUNCHES > before, "the kernel checks launched no kernel")

    ms = time_ms(lambda: gemv.batched_gemv(A, x))
    plain_ms = time_ms(lambda: gemv.batched_gemv_reference(A, x))
    ms_bf16 = time_ms(lambda: gemv.batched_gemv(Ab, x))
    plain_ms_bf16 = time_ms(lambda: gemv.batched_gemv_reference(Ab, x))
    f32_bytes, bf16_bytes = B * n * n * 4, B * n * n * 2
    print(f"gemv f32 (B={B}, n={n}): kernel {ms:.4f} ms "
          f"({f32_bytes / ms / 1e6:.1f} GB/s), plain einsum {plain_ms:.4f} ms "
          f"({f32_bytes / plain_ms / 1e6:.1f} GB/s)")
    print(f"gemv bf16 (B={B}, n={n}): kernel {ms_bf16:.4f} ms "
          f"({bf16_bytes / ms_bf16 / 1e6:.1f} GB/s), plain (upcast + einsum) "
          f"{plain_ms_bf16:.4f} ms")
    return {"max_abs_err": f32_abs, "ms": ms, "plain_ms": plain_ms}


def check_mode(name, r, As, b, x_true=None):
    """Convergence, residual audit and (optionally) the known optimum."""
    require(r.x.shape == b.shape and bool(torch.isfinite(r.x).all()),
            f"{name}: non-finite or misshapen solution")
    conv = float(r.converged.float().mean())
    require(conv == 1.0, f"{name}: convergence {conv} != 1.0")
    res = float(audit_residual(As, b, r.x).max())
    require(res <= TOL * 1.05, f"{name}: audited residual {res} above tol")
    if x_true is not None:
        # Unperturbed b: the optimum x_uncon is interior, and a residual of
        # 2e-5 bounds |x - x*| by 3 n tol / lambda_min(A) = 6e-5.
        err = float((r.x - x_true).abs().max())
        require(err < 1e-3, f"{name}: max |x - x*| = {err}")
    return res


def run_mode(name, run, As, bs, x_uncon, gen, B, sweeps_floor):
    """Warm-up on the unperturbed batch, then REPS timed perturbed calls."""
    before = gemv.LAUNCHES
    r = run(bs)
    torch.cuda.synchronize()
    check_mode(name, r, As, bs, x_uncon)
    launches = gemv.LAUNCHES - before
    max_mv = int(r.matvecs.max())
    require(launches >= max_mv,
            f"{name}: {launches} kernel launches < {max_mv} matvecs of one lane")
    last = {}

    def make_args(rep):
        last["b"] = bs + NOISE * torch.randn(bs.shape, generator=gen,
                                             device=bs.device)
        return (last["b"],)

    out = timed_run(run, reps=REPS, make_args=make_args, warmup=False,
                    implied_bytes=dense_sweep_bytes(B, N, sweeps_floor),
                    check=lambda r_: require(bool(r_.converged.all()),
                                             f"{name}: a timed rep did not converge"))
    res = check_mode(name, out.result, As, last["b"])
    mv = out.result.matvecs.float()
    print(f"{name}: B={B} solves/s {B / out.wall_s:.1f} (min of {REPS} walls "
          f"{[round(w, 5) for w in out.walls]}), p50 matvecs "
          f"{float(mv.median()):.1f}, max matvecs {int(mv.max())}, "
          f"audited max residual {res:.3e}, kernel launches in warm-up call "
          f"{launches}")


def main():
    require(torch.cuda.is_available(), "no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.load()
    print(f"kernel build {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device=dev).manual_seed(SEED)
    measured = check_kernels(gen, dev)
    torch.cuda.empty_cache()

    proj = box(-torch.ones(N), torch.ones(N), device=dev)
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)

    gemv.LAUNCHES = 0
    # ---- iterative mode ----------------------------------------------------
    As, bs, x_uncon = random_qp_batch(gen, B_ITER, N, torch.float32,
                                      diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    run_mode("iterative", lambda b: run_iterative(As, b, diag, proj, cfg),
             As, bs, x_uncon, gen, B_ITER, 10)
    del As, bs, x_uncon, diag
    torch.cuda.empty_cache()

    # ---- direct serving mode -----------------------------------------------
    As, bs, x_uncon = random_qp_batch(gen, B_DIRECT, N, torch.float32,
                                      diag_boost=1.0, chunk=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ainv = spd_inverse_batch(As)
    torch.cuda.synchronize()
    print(f"direct: prep (batched Cholesky inverse, B={B_DIRECT}) "
          f"{time.perf_counter() - t0:.2f} s")
    run_mode("direct", lambda b: run_direct(Ainv, As, b, proj, cfg),
             As, bs, x_uncon, gen, B_DIRECT, 2)
    launches = gemv.LAUNCHES
    require(launches > 0, "the main path launched no kernel")

    print(json.dumps({"kernels": [{
        "name": "batched_gemv", "route": "cuda",
        "source": "ccqppy_tpu_torch/csrc/batched_gemv.cu",
        "replaces": "ccqppy_tpu/ops/pallas_kernels.py:65",
        "launches": launches, **measured}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
