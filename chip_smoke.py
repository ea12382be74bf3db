#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU and check it.

The main path is the batched 1000-dim box-QP workload: B independent QPs
with ``A = G G^T + n I`` (G standard normal), ``b = -A x_uncon``
(x_uncon ~ U(-1, 1)), box [-1, 1], tol 2e-5, a 500-matvec budget, and
right-hand sides perturbed by 1e-3 N(0, 1) per call.  Three modes:

* iterative (B=2048): Jacobi warm start ``clip(-b / diag A, -1, 1)``, then
  verified PCG with fused straggler compaction (phase 1 at 17 matvecs, a
  256-lane bucket), on the dense stack through the GEMV kernel;
* packed (the same B=2048 ensemble): the same solve on
  ``SymmetricPackedDense.from_dense(As, tile=256)``, whose matvec streams
  only the upper tiles through the symv kernel;
* direct serving (B=1024): a one-time batched Cholesky inverse, then per
  call the projected inverse apply, a verification sweep and a compacted
  PCG polish (phase 1 at 3 matvecs, a 64-lane bucket).

Steps: build the CUDA kernels from ``ccqppy_tpu_torch/csrc``; hold each
kernel's entry points against their plain PyTorch versions on the card;
run the three modes at full width, audit every lane's true residual with
the plain f64 GEMV of the dense stack, and check that the kernels carried
each mode (launch counts are zeroed just before a mode and read just after
it).  Any failed check raises, so the exit code is non-zero.  The last line
of standard output is one JSON object naming the device.

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
from ccqppy_tpu_torch.ops import gemv, kernels, symv
from ccqppy_tpu_torch.ops.linop import SymmetricPackedDense
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

TILE_PACKED = 256  # n = 1000 padded to 1024: 10 tiles, 0.655x the dense bytes

B_DIRECT = 1024    # As and A^-1 both resident
PHASE1_DIRECT = 3
BUCKET_DIRECT = 64

REPS = 3           # timed reps per mode
KERNEL_REPS = 25   # timed launches per kernel measurement

GEMV_F32_TOL = 1e-5    # max|y - y_ref| / max|y_ref| against the f64 plain version
GEMV_BF16_TOL = 2e-2   # bf16 A against the f64 GEMV of the f32 A (quantization)
GEMV_BF16_PLAIN_TOL = 1e-5  # bf16 kernel against the plain bf16 version
SYMV_TOL = 1e-5        # max rel err against the f64 plain version (the JAX bound)
# (B, n, tile) of the symv checks; the last is the packed mode's shape.
SYMV_SHAPES = ((3, 512, 128), (3, 512, 256), (2, 1024, 512), (2048, 1024, 256))


def require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def zero_counts():
    """Set every kernel's launch count to 0, just before a mode runs."""
    gemv.LAUNCHES = 0
    symv.LAUNCHES.update(dict.fromkeys(symv.LAUNCHES, 0))


def jacobi_x0(diag, b):
    return torch.clamp(-b / diag, -1.0, 1.0)


def run_iterative(As, b, diag, proj, cfg):
    """One call of the iterative mode."""
    return solve_batched_fused_compact(
        "pcg", As, b, PHASE1, x0=jacobi_x0(diag, b), proj=proj, config=cfg,
        bucket=BUCKET, host_fallback=False)


def run_packed(op, b, proj, cfg):
    """One call of the packed mode: the iterative mode on a packed operator."""
    return solve_batched_fused_compact(
        "pcg", op, b, PHASE1, x0=jacobi_x0(op.diagonal(), b), proj=proj,
        config=cfg, bucket=BUCKET, host_fallback=False)


def run_direct(Ainv, As, b, proj, cfg):
    """One call of the direct serving mode."""
    return solve_direct_batched(Ainv, As, b, proj, cfg, phase1=PHASE1_DIRECT,
                                bucket=BUCKET_DIRECT, host_fallback=False)


def chunked_f64(plain, *args, chunk=256):
    """A plain version in f64, in lane chunks to bound the f64 copies."""
    return torch.cat([plain(*(a[i:i + chunk].double() for a in args))
                      for i in range(0, args[0].shape[0], chunk)])


def gemv_f64(A, x):
    """Plain GEMV in f64."""
    return chunked_f64(gemv.batched_gemv_reference, A, x)


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


def symmetric_batch(gen, dev, B, n, chunk=256):
    """A = G + G^T, G standard normal, built in lane chunks."""
    A = torch.empty((B, n, n), device=dev)
    for i in range(0, B, chunk):
        G = torch.randn((min(chunk, B - i), n, n), generator=gen, device=dev)
        torch.add(G, G.mT, out=A[i:i + chunk])
    return A


def bits(y):
    return y.contiguous().view(torch.int32)


def check_entry(name, fn, ref):
    """Kernel entry point against its f64 plain version, and bitwise
    repeatable over two launches.  Returns (y, rel err, max abs err)."""
    y = fn()
    y2 = fn()
    require(torch.equal(bits(y), bits(y2)), f"{name}: two launches differ")
    require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = rel_err(y, ref)
    require(err < SYMV_TOL, f"{name}: rel err {err}")
    return y, err, float((y.double() - ref).abs().max())


def check_symv(gen, dev):
    """The three symv entry points against their plain versions on the
    card; returns the measurements of each at the packed mode's shape, with
    the launches this check made of each."""
    before = dict(symv.LAUNCHES)
    measured = {}
    for B, n, tile in SYMV_SHAPES:
        A = symmetric_batch(gen, dev, B, n)
        x = torch.randn((B, n), generator=gen, device=dev)
        Ap = symv.pack_symmetric(A, tile)
        tag = f"B={B} n={n} tile={tile}"
        y_full, err_full, abs_full = check_entry(
            f"batched_symv {tag}", lambda: symv.batched_symv(A, x, tile),
            chunked_f64(lambda a, v: symv.batched_symv_reference(a, v, tile), A, x))
        y_pack, err_pack, abs_pack = check_entry(
            f"batched_symv_packed {tag}", lambda: symv.batched_symv_packed(Ap, x),
            chunked_f64(lambda a, v: symv.batched_symv_packed_reference(a, v, n), Ap, x))
        y_one, err_one, abs_one = check_entry(
            f"symv_packed n={n} tile={tile}", lambda: symv.symv_packed(Ap[0], x[0]),
            symv.symv_packed_reference(Ap[0].double(), x[0].double(), n))
        print(f"symv {tag}: rel err full {err_full:.3e}, packed {err_pack:.3e}, "
              f"single {err_one:.3e}")
        # The strictly-lower off-diagonal tiles of the full layout are never
        # read: NaN there leaves the output bitwise the same.
        for i in range(n // tile):
            A[:, (i + 1) * tile:, i * tile:(i + 1) * tile] = torch.nan
        y_nan = symv.batched_symv(A, x, tile)
        require(torch.equal(bits(y_nan), bits(y_full)),
                f"batched_symv {tag}: output changed with NaN lower tiles")
        if (B, n, tile) != SYMV_SHAPES[-1]:
            continue
        packed_bytes = Ap.numel() * 4
        ms_pack = time_ms(lambda: symv.batched_symv_packed(Ap, x))
        plain_pack = time_ms(lambda: symv.batched_symv_packed_reference(Ap, x, n))
        ms_full = time_ms(lambda: symv.batched_symv(A, x, tile))
        plain_full = time_ms(lambda: symv.batched_symv_reference(A, x, tile))
        ms_one = time_ms(lambda: symv.symv_packed(Ap[0], x[0]))
        plain_one = time_ms(lambda: symv.symv_packed_reference(Ap[0], x[0], n))
        for label, ms, plain in (("packed", ms_pack, plain_pack),
                                 ("full layout", ms_full, plain_full)):
            print(f"symv {label} ({tag}, {packed_bytes / 1e9:.3f} GB of tiles): "
                  f"kernel {ms:.4f} ms ({packed_bytes / ms / 1e6:.1f} GB/s), "
                  f"plain {plain:.4f} ms ({packed_bytes / plain / 1e6:.1f} GB/s)")
        print(f"symv_packed (B=1, n={n}, tile={tile}): kernel {ms_one:.4f} ms, "
              f"plain {plain_one:.4f} ms")
        measured = {
            "batched_symv": {"max_abs_err": abs_full, "ms": ms_full, "plain_ms": plain_full},
            "batched_symv_packed": {"max_abs_err": abs_pack, "ms": ms_pack,
                                    "plain_ms": plain_pack},
            "symv_packed": {"max_abs_err": abs_one, "ms": ms_one, "plain_ms": plain_one},
        }
        del y_full, y_pack, y_one, y_nan
    for name, m in measured.items():
        m["kernel_phase_launches"] = symv.LAUNCHES[name] - before[name]
        require(m["kernel_phase_launches"] > 0, f"the symv checks launched no {name}")
    return measured


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


def run_mode(name, run, As, bs, x_uncon, gen, sweep_bytes, sweeps_floor, count):
    """Warm-up on the unperturbed batch, then REPS timed perturbed calls.
    ``count()`` reads the launch count of the kernel that carries the mode's
    matvecs.  Returns the warm-up call's result."""
    B = bs.shape[0]
    before = count()
    r = run(bs)
    torch.cuda.synchronize()
    check_mode(name, r, As, bs, x_uncon)
    launches = count() - before
    max_mv = int(r.matvecs.max())
    require(launches >= max_mv,
            f"{name}: {launches} kernel launches < {max_mv} matvecs of one lane")
    last = {}

    def make_args(rep):
        last["b"] = bs + NOISE * torch.randn(bs.shape, generator=gen,
                                             device=bs.device)
        return (last["b"],)

    out = timed_run(run, reps=REPS, make_args=make_args, warmup=False,
                    implied_bytes=sweep_bytes * sweeps_floor,
                    check=lambda r_: require(bool(r_.converged.all()),
                                             f"{name}: a timed rep did not converge"))
    res = check_mode(name, out.result, As, last["b"])
    mv = out.result.matvecs.float()
    print(f"{name}: B={B} solves/s {B / out.wall_s:.1f} (min of {REPS} walls "
          f"{[round(w, 5) for w in out.walls]}), p50 matvecs "
          f"{float(mv.median()):.1f}, max matvecs {int(mv.max())}, "
          f"audited max residual {res:.3e}, kernel launches in warm-up call "
          f"{launches}")
    return r


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
    measured_symv = check_symv(gen, dev)
    torch.cuda.empty_cache()

    proj = box(-torch.ones(N), torch.ones(N), device=dev)
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)

    # ---- iterative mode ----------------------------------------------------
    As, bs, x_uncon = random_qp_batch(gen, B_ITER, N, torch.float32,
                                      diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    zero_counts()
    r_dense = run_mode("iterative", lambda b: run_iterative(As, b, diag, proj, cfg),
                       As, bs, x_uncon, gen, dense_sweep_bytes(B_ITER, N, 1), 10,
                       lambda: gemv.LAUNCHES)
    gemv_launches = gemv.LAUNCHES
    require(gemv_launches > 0, "the iterative mode launched no GEMV kernel")
    del diag

    # ---- packed mode: the same ensemble through the symv kernel -------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = SymmetricPackedDense.from_dense(As, tile=TILE_PACKED)
    torch.cuda.synchronize()
    packed_bytes = op.Ap.numel() * 4
    print(f"packed: from_dense (B={B_ITER}, n={N} -> {op.npad}, tile={TILE_PACKED}) "
          f"{time.perf_counter() - t0:.2f} s, {packed_bytes / 1e9:.3f} GB of tiles "
          f"against {As.numel() * 4 / 1e9:.3f} GB dense")
    zero_counts()
    r_packed = run_mode("packed", lambda b: run_packed(op, b, proj, cfg),
                        As, bs, x_uncon, gen, packed_bytes, 10,
                        lambda: symv.LAUNCHES["batched_symv_packed"])
    # The packed operator's matvec is batched_symv_packed; the full layout
    # and the single-problem wrapper are not on this path.
    symv_launches = dict(symv.LAUNCHES)
    require(symv_launches["batched_symv_packed"] > 0,
            "the packed mode launched no batched_symv_packed kernel")
    require(symv_launches["batched_symv"] == symv_launches["symv_packed"] == 0,
            f"the packed mode launched another symv entry: {symv_launches}")
    require(gemv.LAUNCHES == 0, "the packed mode launched the dense GEMV kernel")
    differ = int((r_packed.matvecs != r_dense.matvecs).sum())
    print(f"packed: {differ} of {B_ITER} lanes differ in matvec count from the "
          f"dense iterative warm-up call")
    del As, bs, x_uncon, op, r_dense, r_packed
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
    zero_counts()
    run_mode("direct", lambda b: run_direct(Ainv, As, b, proj, cfg),
             As, bs, x_uncon, gen, dense_sweep_bytes(B_DIRECT, N, 1), 2,
             lambda: gemv.LAUNCHES)
    require(gemv.LAUNCHES > 0, "the direct mode launched no GEMV kernel")
    require(not any(symv.LAUNCHES.values()), "the direct mode launched a symv kernel")
    gemv_launches += gemv.LAUNCHES

    # ``launches`` is each entry's count over the main path's modes (0 for
    # the two symv entries no mode runs); ``kernel_phase_launches`` counts
    # the symv checks above, which are not part of the main path.
    symv_src = "ccqppy_tpu_torch/csrc/batched_symv.cu"
    symv_lines = {"batched_symv": 133, "batched_symv_packed": 248, "symv_packed": 292}
    print(json.dumps({"kernels": [
        {"name": "batched_gemv", "route": "cuda",
         "source": "ccqppy_tpu_torch/csrc/batched_gemv.cu",
         "replaces": "ccqppy_tpu/ops/pallas_kernels.py:65",
         "launches": gemv_launches, **measured},
        *({"name": name, "route": "cuda", "source": symv_src,
           "replaces": f"ccqppy_tpu/ops/pallas_kernels.py:{line}",
           "launches": symv_launches[name], **measured_symv[name]}
          for name, line in symv_lines.items())]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
