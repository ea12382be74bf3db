#!/usr/bin/env python3
"""The deep row of ``benchmarks/benchmark_f64_wishart1k.py`` on the card,
beside plain f64 PCG, and where the time of chip_smoke.py's mode (j) goes.

The ensemble is chip_smoke.py's mode (j), drawn the same way (B=64 raw
Wishart QPs of n=1000 in f64, box [-1, 1], the Jacobi start); b is
perturbed once by 1e-3 N(0, 1) from a generator of its own.  Two solves of
one call each, with per-lane stopping and no continuation chunks:

* the f64-exact rung (rr-PCG on ``MixedPrecDense(A, A.float())``, refresh
  every 128, segment drop 0.25) at tol 1e-10 with the benchmark's budget
  of 80,000 matvecs;
* plain PCG on ``DenseOperator(A)`` (the GEMV kernel's f64 instance) at
  the same tol and budget, on the same b.

For each it prints the wall, the share of lanes converged, p50/max matvecs,
the GEMV launches by instance and the audited max residual (f64, plain
GEMV), and for any lane left at the budget its condition number
(``eigvalsh``) and residual.  A lane at the budget is a result, not a
failure; a lane reported converged whose audited residual exceeds tol by
more than 5% fails the run.  Then one call of each at mode (j)'s tol 1e-5
under ``torch.profiler`` (``tools/profile_modes.py``): wall, device busy
time, idle share, kernels an iteration.

Run:  python3 tools/f64_deep.py      (needs one CUDA GPU, nvcc for sm_90a)
"""
import importlib.util
import pathlib
import subprocess
import time

import torch

TOL_DEEP, BUDGET_DEEP = 1e-10, 80_000   # the benchmark's deepest row
SEED_B = 5                              # the generator of the perturbation

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_profile_modes():
    spec = importlib.util.spec_from_file_location("profile_modes",
                                                  ROOT / "tools" / "profile_modes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deep_row(cs, name, run, As, b, proj64):
    """One call of ``run(b)``: prints the row, checks the converged lanes'
    audit, and reports the lanes left at the budget."""
    gemv = cs.gemv
    cs.zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    audit = cs.audit_residual(As, b, r.x, proj64)
    conv = r.converged
    mv = r.matvecs.float()
    res_conv = float(audit[conv].max()) if bool(conv.any()) else float("nan")
    print(f"{name} (tol {TOL_DEEP}, budget {BUDGET_DEEP}, B={b.shape[0]}): one call {wall:.3f} s, "
          f"solves/s {b.shape[0] / wall:.3f}, converged {float(conv.float().mean())}, p50 "
          f"matvecs {float(mv.median()):.1f}, max {int(mv.max())}, iterations of the slowest "
          f"lane {int(r.iterations.max())}, GEMV launches {cs.f32_launches()} f32, "
          f"{gemv.LAUNCHES_F64} f64, audited max residual of the converged lanes "
          f"{res_conv:.3e}, of all lanes {float(audit.max()):.3e}", flush=True)
    cs.require(not bool(conv.any()) or res_conv <= TOL_DEEP * 1.05,
               f"{name}: a converged lane audits at {res_conv}, above tol")
    left = torch.nonzero(~conv).squeeze(1)
    if left.numel():
        w = torch.linalg.eigvalsh(As[left])
        for k, lane in enumerate(left.tolist()):
            print(f"  lane {lane} at the budget: condition {float(w[k, -1] / w[k, 0]):.4e}, "
                  f"residual {float(audit[lane]):.3e}", flush=True)
    return r


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    pm = load_profile_modes()
    cs = pm.load_chip_smoke()
    cs.kernels.build()
    cs.kernels.load()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)    # chip_smoke.py's (j)
    As, bs, _ = cs.random_qp_batch(gen, cs.B_F64, cs.N, torch.float64, diag_boost=0.0)
    As32 = As.float()
    diag = As.diagonal(dim1=-2, dim2=-1)
    proj64 = cs.box(-torch.ones(cs.N), torch.ones(cs.N), dtype=torch.float64, device=dev)
    b = bs + cs.NOISE * torch.randn(bs.shape, generator=torch.Generator(device=dev).manual_seed(
        SEED_B), device=dev)

    rung = cs.PCGConfig(tol=TOL_DEEP, max_matvecs=BUDGET_DEEP, refresh_every=cs.REFRESH_F64,
                        segment_drop=cs.SEGMENT_DROP_F64)
    plain = cs.PCGConfig(tol=TOL_DEEP, max_matvecs=BUDGET_DEEP)
    deep_row(cs, "f64 rung deep", lambda b_: cs.run_rung(As, As32, b_, diag, proj64, rung),
             As, b, proj64)
    deep_row(cs, "f64 plain pcg deep", lambda b_: cs.run_f64_plain(As, b_, diag, proj64, plain),
             As, b, proj64)

    def max_iterations(r):
        return int(r.iterations.max())

    rung5 = cs.PCGConfig(tol=cs.TOL_F64, max_matvecs=cs.BUDGET_F64,
                         refresh_every=cs.REFRESH_F64, segment_drop=cs.SEGMENT_DROP_F64)
    plain5 = cs.PCGConfig(tol=cs.TOL_F64, max_matvecs=cs.BUDGET_F64)
    pm.profiled("(j) f64 rung, tol 1e-5", lambda: cs.run_rung(As, As32, b, diag, proj64, rung5),
                max_iterations)
    pm.profiled("(j) f64 plain pcg, tol 1e-5",
                lambda: cs.run_f64_plain(As, b, diag, proj64, plain5), max_iterations)


if __name__ == "__main__":
    main()
