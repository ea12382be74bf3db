"""The yardstick: the generator copy, the reference's sets, residual and
solver, the control's rounding, the byte and FLOP counts and the trace
reduction."""
import math

import numpy as np
import pytest
import torch

from qpbench import counts, trace, traffic
from qpbench.reference import control, sets, solve
from qpbench.registry import Registry

BOX = {"kind": "box", "lower": -1.0, "upper": 1.0}
CONE = {"kind": "lorentz_blocks", "block_dim": 3, "mu": 1.0}


def test_generator_copy_matches_the_programs_generator():
    from ccqppy_tpu_torch.utils.random_qp import random_qp_batch

    cfg = Registry().config("box1000") | {"n": 30}
    A, b, x = traffic.draw(cfg, 5, torch.Generator().manual_seed(11), chunk=2)
    A2, b2, x2 = random_qp_batch(torch.Generator().manual_seed(11), 5, 30,
                                 diag_boost=1.0, chunk=2)
    assert A.shape == (5, 30, 30) and b.shape == x.shape == (5, 30)
    assert torch.equal(A, A2) and torch.equal(b, b2) and torch.equal(x, x2)
    assert float(x.min()) >= -1 and float(x.max()) <= 1
    # A = G G^T + n I: symmetric, its least eigenvalue at least n.
    assert torch.equal(A, A.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(A.double()).min()) > 30 * 0.999


def test_seeds_fix_the_ensemble_and_each_call():
    cfg = Registry().config("cone999") | {"n": 12}
    big = 2**31 + 12345
    A, b0, _ = traffic.ensemble(cfg, 3, big, torch.device("cpu"))
    A2, b02, _ = traffic.ensemble(cfg, 3, big, torch.device("cpu"))
    assert torch.equal(A, A2) and torch.equal(b0, b02)
    assert not torch.equal(A, traffic.ensemble(cfg, 3, big + 1, torch.device("cpu"))[0])
    b1 = traffic.call_rhs(b0, big, 4, 1e-3)
    assert torch.equal(b1, traffic.call_rhs(b0, big, 4, 1e-3))
    assert not torch.equal(b1, traffic.call_rhs(b0, big, 5, 1e-3))
    assert 0 < float((b1 - b0).abs().max()) < 1e-2


def test_sampler_keeps_a_uniform_sample_and_the_longest_lanes():
    spec = {"uniform": 5, "longest": 3, "uniform_per_call": 2, "longest_per_call": 2}
    s = traffic.Sampler(spec, 7)
    for k in range(20):
        mv = np.full(8, 10, np.int32)
        mv[k % 8] = 100 + k
        s.offer(k, np.full((8, 4), k, np.float32), np.ones(8, bool), mv)
    recs = s.records()
    assert len(s.uniform) == 5 and s.seen == 40
    assert sorted(e[0] for e in s.longest) == [117, 118, 119]
    assert all(float(r[4][0]) == r[0] for r in recs)


def test_projections_by_hand():
    x = torch.tensor([[2.0, -3.0, 0.5]], dtype=torch.float64)
    assert torch.equal(sets.project(BOX, x), torch.tensor([[1.0, -1.0, 0.5]], dtype=torch.float64))
    # Cone blocks (u1, u2, z): inside, polar, and the surface case.
    x = torch.tensor([[0.3, 0.4, 1.0, 3.0, 4.0, -6.0, 3.0, 4.0, 0.0]], dtype=torch.float64)
    p = sets.project(CONE, x)
    assert torch.allclose(p[0, :3], x[0, :3])
    assert torch.equal(p[0, 3:6], torch.zeros(3, dtype=torch.float64))
    # (3, 4, 0): ||u|| = 5, t = (5 + 0) / 2 = 2.5, u -> 2.5 (0.6, 0.8).
    assert torch.allclose(p[0, 6:], torch.tensor([1.5, 2.0, 2.5], dtype=torch.float64))


def test_residual_by_hand():
    gd = 1e-6
    # Box: interior -> g; at the upper bound with g < 0 (pushing out) -> 0.
    x = torch.tensor([[0.5, 1.0]], dtype=torch.float64)
    g = torch.tensor([[0.3, -2.0]], dtype=torch.float64)
    assert math.isclose(float(sets.pg_residual(BOX, x, g, gd)), 0.3 / 6, rel_tol=1e-6)
    # Cone surface point (0.6, 0.8, 1.0), outward normal (0.6, 0.8, -1)/sqrt2;
    # g = -2 nrm (pushing out) leaves nothing; g = +nrm (pushing in) stays.
    x = torch.tensor([[0.6, 0.8, 1.0]], dtype=torch.float64)
    nrm = torch.tensor([[0.6, 0.8, -1.0]], dtype=torch.float64) / 2 ** 0.5
    assert float(sets.pg_residual(CONE, x, -2 * nrm, gd)) < 1e-12
    assert math.isclose(float(sets.pg_residual(CONE, x, nrm, gd)), 1 / 9, rel_tol=1e-9)
    # Inside: g; at the apex: -P(-g); outside beyond the band: huge.
    inside = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    g = torch.tensor([[1.0, 2.0, 2.0]], dtype=torch.float64)
    assert math.isclose(float(sets.pg_residual(CONE, inside, g, gd)), 3 / 9, rel_tol=1e-12)
    apex = torch.zeros((1, 3), dtype=torch.float64)
    assert math.isclose(float(sets.pg_residual(CONE, apex, -g, gd)),
                        float(torch.linalg.vector_norm(sets.project(CONE, g))) / 9, rel_tol=1e-12)
    out = torch.tensor([[0.6, 0.8, 0.99]], dtype=torch.float64)
    assert float(sets.pg_residual(CONE, out, -2 * nrm, gd)) > 1e2


@pytest.mark.parametrize("spec", [BOX, CONE], ids=["box", "cone"])
def test_reference_solve_reaches_its_optimum(spec):
    cfg = Registry().config("box1000") | {"n": 18}
    A, b, _ = traffic.draw(cfg, 4, torch.Generator().manual_seed(3))
    A, b = A.double(), 5 * b.double()
    x, res, steps = solve.solve(A, b, spec, 1e-6)
    assert float(res.max()) <= 1e-10 and steps > 0
    # Optimality in the variational form: no feasible point improves by a step.
    f = lambda z: 0.5 * (z * solve.bmv(A, z)).sum(-1) + (b * z).sum(-1)
    for _ in range(20):
        y = sets.project(spec, x + 0.05 * torch.randn_like(x))
        assert bool((f(y) >= f(x) - 1e-9).all())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-12, -1.5 - 2**-12])
    r = control.tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-10, -1.5]
    y = torch.randn(1000)
    rel = ((control.tf32(y) - y).abs() / y.abs()).max()
    assert 2**-13 < float(rel) <= 2**-11


def test_sweep_counts_on_known_shapes():
    assert counts.sweep_bytes(1000, 1) == (1000 * 1000 + 2000) * 4
    assert counts.sweep_bytes(999, 3) == 3 * (999 * 999 + 2 * 999) * 4
    assert counts.sweep_flops(1000, 2) == 4e6
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    t, by = counts.least_seconds(1000, 2048, "float32", peak)
    assert by == "bytes" and math.isclose(t, 2048 * 4008000 / 3.35e12)
    assert counts.peaks("cpu") is None


def test_trace_reduction_on_a_made_up_window():
    host = [("qpbench.call", 0.0, 1.0), ("aten::nonzero", 0.30, 0.45),
            ("cudaLaunchKernel", 0.42, 0.43), ("qpbench.fetch", 1.0, 1.2),
            ("qpbench.call", 1.5, 2.0), ("qpbench.fetch", 2.0, 2.1)]
    dev = [("void batched_gemv_kernel<float>", 0.05, 0.25), ("add_kernel", 0.25, 0.30),
           ("add_kernel", 0.5, 0.6), ("Memcpy DtoH (Device -> Pinned)", 1.05, 1.1),
           ("void batched_gemv_kernel<float>", 1.6, 1.9), ("late", 2.5, 2.6)]
    s = trace.summarize(dev, host, 2)
    assert math.isclose(s.window_s, 2.1) and math.isclose(s.busy_s, 0.2 + 0.05 + 0.1 + 0.05 + 0.3)
    assert s.kernels == 4 and math.isclose(s.gemv_s, 0.5)
    assert math.isclose(s.other_kernel_s, 0.15)
    gaps = dict(s.idle_gaps)
    # 0.30-0.50: in nonzero (its launch at 0.42-0.43 is not at the middle);
    # 1.1-1.6, its middle between the calls' spans: the caller's loop.
    assert math.isclose(gaps["aten::nonzero"], 0.2) and math.isclose(gaps[trace.LOOP], 0.5)
    assert math.isclose(gaps["qpbench.call"], 0.5) and math.isclose(gaps["qpbench.fetch"], 0.2)
    assert math.isclose(sum(gaps.values()), s.window_s - s.busy_s)
    assert s.device_ops[0][0].startswith("void batched_gemv")
    assert trace.summarize([], host, 2) is None
