#!/usr/bin/env python3
"""Where the time of one call goes, for chip_smoke.py's modes (g), (h), (i).

Builds the kernels, makes chip_smoke.py's ensembles (same seeds, same
widths; the cone and box ensembles are each drawn first from their own
generator, so they are not the script's exact batches), runs each mode once
to warm up, then once under ``torch.profiler``, and prints per mode: the
wall of the profiled call, the device busy time (the CUDA kernel entries of
``key_averages()``, each kernel counted once), the idle share 1 - busy /
wall, the kernels launched, the GEMV kernel's launches and time, and the
kernels per iteration of the slowest lane.  The profiler adds host time, so
its walls are longer than chip_smoke.py's.

Run:  python3 tools/profile_modes.py      (needs one CUDA GPU, nvcc for sm_90a)
"""
import importlib.util
import pathlib
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiled(name, run, iterations):
    """Warm up, then profile one call of ``run()``; print the breakdown."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda) / 1e6
    kernels = sum(e.count for e in cuda)
    gemv = [e for e in cuda if "batched_gemv_kernel" in e.key]
    gemv_n = sum(e.count for e in gemv)
    gemv_s = sum(e.self_device_time_total for e in gemv) / 1e6
    its = iterations(r)
    print(f"{name}: profiled wall {wall:.4f} s, device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.3f}), {kernels} kernels ({kernels / its:.1f} an iteration of "
          f"the slowest lane, {its} iterations), GEMV {gemv_n} launches {gemv_s:.4f} s "
          f"({1e3 * gemv_s / max(gemv_n, 1):.4f} ms each)", flush=True)
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:10.2f} ms {e.count:7d}x {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = load_chip_smoke()
    cs.kernels.build()
    cs.kernels.load()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))

    def max_iterations(r):
        return int(r.iterations.max())

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    As, bs, _ = cs.random_qp_batch(gen, cs.B_CONE, cs.N_CONE, torch.float32,
                                   diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    cone = cs.cone_proj(device=dev)
    keys = cs.split_keys(cs.SEED_SPG, cs.B_CONE, dev)
    cfg_spg = cs.SPGConfig(tol=cs.TOL_CONE, max_matvecs=cs.BUDGET_CONE)
    cfg_ar = cs.APGDConfig(tol=cs.TOL_CONE, max_matvecs=cs.BUDGET_CONE)
    profiled("(g) cone spg", lambda: cs.run_cone_spg(As, bs, cone, cfg_spg, keys),
             max_iterations)
    profiled("(h) cone apgd_ar", lambda: cs.run_cone_apgd_ar(As, bs, diag, cone, cfg_ar),
             max_iterations)
    del As, bs, diag
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    As, bs, _ = cs.random_qp_batch(gen, cs.B_ITER, cs.N, torch.float32,
                                   diag_boost=1.0, chunk=256)
    diag = As.diagonal(dim1=-2, dim2=-1)
    box = cs.box(-torch.ones(cs.N), torch.ones(cs.N), device=dev)
    cfg = cs.APGDConfig(tol=cs.TOL_APGD_BOX, max_matvecs=cs.BUDGET_APGD)
    profiled("(i) box apgd", lambda: cs.run_box_apgd(As, bs, diag, box, cfg), max_iterations)


if __name__ == "__main__":
    main()
