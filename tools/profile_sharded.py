#!/usr/bin/env python3
"""Where the time of chip_smoke.py's (m) goes, beside (k), at world 1 over NCCL.

Builds (k)'s huge block-sparse QP (n = 1,000,000, seed 0), joins a
one-rank NCCL process group as chip_smoke.py does, runs (k)'s unsharded
PCG and (m)'s row-sharded one once each to warm up, then once each under
``torch.profiler``, and prints per run: the wall of the profiled call, the
device busy time (the CUDA entries of ``key_averages()``), the idle share
1 - busy / wall, the kernels launched per iteration, the collectives per
iteration, and the CPU ops with the most self time (the collectives' host
work among them).  The profiler adds host time, so its walls are longer
than chip_smoke.py's.

Run:  python3 tools/profile_sharded.py      (needs one CUDA GPU)
"""
import importlib.util
import os
import pathlib
import sys
import time

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiled(cs, name, run):
    """Warm up, then profile one call of ``run()``; print the breakdown."""
    run()
    torch.cuda.synchronize()
    cs.zero_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(cs.COLLECTIVES)
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda) / 1e6
    kernels = sum(e.count for e in cuda)
    its = int(r.iterations[0])
    print(f"{name}: profiled wall {wall:.4f} s ({1e3 * wall / its:.3f} ms an iteration, {its} "
          f"iterations), device busy {busy:.4f} s (idle share {1 - busy / wall:.3f}), "
          f"{kernels / its:.1f} kernels an iteration, "
          f"{sum(counts.values()) / its:.2f} collectives an iteration {counts}", flush=True)
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:10]
    for e in cpu:
        print(f"    self cpu {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"({e.self_cpu_time_total / max(e.count, 1):8.1f} us each) {e.key[:70]}")
    nccl = [e for e in cuda if "nccl" in e.key.lower()]
    for e in nccl:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x {e.key[:70]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    cs = load_chip_smoke()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    os.environ["NCCL_SOCKET_IFNAME"] = "lo"
    cs.init_distributed(f"127.0.0.1:{cs.free_port()}", 1, 0, device="cuda",
                        timeout=cs.DIST_TIMEOUT)
    mesh = cs.make_mesh(axis="model")
    op, b, _ = cs.block_tridiag_qp(cs.N_HUGE, cs.SEED_HUGE, device=dev)
    proj = cs.box(-torch.ones(cs.N_HUGE), torch.ones(cs.N_HUGE), device=dev)
    cfg = cs.PCGConfig(tol=cs.TOL_HUGE, max_matvecs=cs.BUDGET_HUGE)
    profiled(cs, "(k) unsharded", lambda: cs.run_huge(op, b, proj, cfg))
    profiled(cs, "(m) sharded, world 1", lambda: cs.run_huge_sharded(op, b, proj, cfg, mesh))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
