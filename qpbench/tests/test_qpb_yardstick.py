"""The yardstick: the generator copy, the reference's sets, residual and
solver, the control's rounding, the byte and FLOP counts, the trace
reduction, the check's chunks and the readers of single kernels."""
import math

import numpy as np
import pytest
import torch

from qpbench import check, counts, harness, trace, traffic
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


def test_bf16_sweeps_count_two_bytes_an_element():
    assert counts.sweep_bytes(1000, 3, "bfloat16") == 3 * (1000 * 1000 + 2000) * 2
    assert counts.sweep_bytes(1000, 3, "bfloat16") * 2 == counts.sweep_bytes(1000, 3)
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    t, by = counts.least_seconds(1000, 2048, "bfloat16", peak)
    assert by == "bytes" and math.isclose(t, 2048 * 2004000 / 3.35e12)
    # The f32 readers' arithmetic is what it was.
    assert counts.least_seconds(1000, 2048, "float32", peak) == \
        (2048 * 4008000.0 / 3.35e12, "bytes")


def test_sc_step_bytes():
    # A v, b, x, y read and x, y, v written: seven (1024, 999) f32 vectors.
    assert counts.sc_step_bytes(999, 1024, 0) == 7 * 1024 * 999 * 4 == 28_643_328
    assert counts.sc_step_bytes(999, 22 * 1024, 0, dtype="float64") == \
        22 * 7 * 1024 * 999 * 8
    # A verifying step reads no y (six vectors); a done lane reads x or y
    # and writes v (two).
    assert counts.sc_step_bytes(999, 3, 5, 1) == (3 * 7 - 1 + 5 * 2) * 999 * 4
    assert counts.sc_step_bytes(999, 0, 1024) == 2 * 1024 * 999 * 4


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


def _fixed_events():
    """Two calls of a made-up trace: program spans (a phase-2 span that
    overlaps a gather span and one that outlasts the window), kernels of
    three names, a copy, and device time inside and outside the window."""
    host = [("qpbench.draw", -0.2, -0.05), ("qpbench.call", 0.0, 1.0),
            ("ccqppy.solve", 0.02, 0.9), ("ccqppy.phase1", 0.03, 0.35),
            ("aten::nonzero", 0.30, 0.45), ("cudaLaunchKernel", 0.42, 0.43),
            ("ccqppy.gather", 0.36, 0.47), ("ccqppy.phase2", 0.44, 0.8),
            ("qpbench.fetch", 1.0, 1.2), ("qpbench.draw", 1.3, 1.45),
            ("qpbench.call", 1.5, 2.0), ("ccqppy.solve", 1.55, 1.95),
            ("qpbench.fetch", 2.0, 2.1), ("ccqppy.phase2", 2.05, 2.5)]
    dev = [("early", -0.1, 0.01), ("void batched_gemv_kernel<float>", 0.05, 0.25),
           ("add_kernel", 0.25, 0.30), ("add_kernel", 0.5, 0.6),
           ("void apgd_sc_step_kernel<float>", 0.62, 0.64),
           ("Memcpy DtoH (Device -> Pinned)", 1.05, 1.1),
           ("void batched_gemv_kernel<float>", 1.6, 1.9),
           ("void apgd_sc_step_kernel<float>", 1.92, 1.93), ("late", 2.5, 2.6)]
    return dev, host


def test_the_summarys_earlier_fields_are_pinned():
    """Every field the summary had before it kept kernels, spans and idle
    intervals, as the reduction gave them then on this trace."""
    s = trace.summarize(*_fixed_events(), 2)
    assert (s.window_s, s.busy_s, s.kernels) == (2.1, 0.7399999999999999, 7)
    assert (s.gemv_s, s.other_kernel_s) == (0.49999999999999983, 0.19)
    assert s.device_ops == [["void batched_gemv_kernel<float>", 0.49999999999999983],
                            ["add_kernel", 0.14999999999999997],
                            ["Memcpy DtoH (Device -> Pinned)", 0.050000000000000044],
                            ["void apgd_sc_step_kernel<float>", 0.030000000000000027],
                            ["early", 0.01]]
    assert s.idle_gaps == [["qpbench.draw", 0.5], ["ccqppy.solve", 0.43000000000000005],
                           ["ccqppy.gather", 0.2], ["qpbench.fetch", 0.17000000000000015],
                           ["ccqppy.phase1", 0.04], ["ccqppy.phase2", 0.020000000000000018]]


def test_kernels_spans_and_idle_by_hand():
    s = trace.summarize(*_fixed_events(), 2)
    # Kernels in [0, 2.1], clipped: the copy and the late op left out.
    assert s.kernel_launches == {"early": 1, "void batched_gemv_kernel<float>": 2,
                                 "add_kernel": 2, "void apgd_sc_step_kernel<float>": 2}
    for name, want in (("early", 0.01), ("void batched_gemv_kernel<float>", 0.5),
                       ("add_kernel", 0.15), ("void apgd_sc_step_kernel<float>", 0.03)):
        assert math.isclose(s.kernel_s[name], want)
    assert set(s.spans) == {"ccqppy.solve", "ccqppy.phase1", "ccqppy.gather", "ccqppy.phase2"}
    assert s.spans["ccqppy.solve"] == [[0.02, 0.9], [1.55, 1.95]]
    assert s.spans["ccqppy.phase2"] == [[0.44, 0.8], [2.05, 2.1]]
    want = [(0.01, 0.05), (0.30, 0.5), (0.6, 0.62), (0.64, 1.05), (1.1, 1.6), (1.9, 1.92),
            (1.93, 2.1)]
    assert len(s.idle) == len(want)
    assert all(math.isclose(a, c) and math.isclose(b, d) for (a, b), (c, d) in zip(s.idle, want))
    assert math.isclose(sum(b - a for a, b in s.idle), s.window_s - s.busy_s)
    assert trace.merged([(0.3, 0.5), (0.0, 0.1), (0.05, 0.2), (0.5, 0.6)]) == \
        [[0.0, 0.2], [0.3, 0.6]]
    assert math.isclose(trace.overlap([[0.0, 0.2], [0.3, 0.6]], [[0.1, 0.35], [0.5, 1.0]]),
                        0.1 + 0.05 + 0.1)
    assert trace.overlap([], [[0.0, 1.0]]) == 0.0


def _record(mix, config, kind="NVIDIA H100 80GB HBM3", walls=(1.0, 0.5)):
    return harness.Record(config=config, mix=mix, setup_s=1.0, window=harness.Part(),
                          uncounted_sweeps=0, device_kind=kind, peak_bytes=None,
                          profiled=harness.Part(walls=list(walls)),
                          trace=trace.summarize(*_fixed_events(), 2))


def test_the_new_readers_on_a_fixed_trace():
    reg = Registry()
    cone = {"n": 999, "dtype": "float32"}
    rec = _record({"lanes": 4}, cone)
    # Two calls, one step launch each over 4 lanes: 8 lane-steps, 6 of them
    # live (the lanes' matvecs), 3 of those the converged lanes' verifying
    # steps, 2 on done lanes: (6 x 7 - 3 + 2 x 2) vectors of 999 x 4 B at
    # 3.35 TB/s over the launches' 0.03 s.
    rec.profiled.matvecs = [np.array([1, 1, 1, 0]), np.array([1, 0, 1, 1])]
    rec.profiled.converged = 3
    rec.profiled.counters = {"sc_steps_fused": 2, "sc_steps_eager": 0}
    assert math.isclose(reg.reader("sc_step_roofline_pct").read(rec),
                        100 * 43 * 999 * 4 / 3.35e12 / 0.03)
    # The trace's launches are not the program's fused steps, or some
    # steps ran on the eager body, or more live steps than launched lanes.
    for counters in ({"sc_steps_fused": 3, "sc_steps_eager": 0},
                     {"sc_steps_fused": 2, "sc_steps_eager": 1}):
        rec.profiled.counters = counters
        assert reg.reader("sc_step_roofline_pct").read(rec) is None
    rec.profiled.counters = None
    rec.profiled.matvecs.append(np.array([1, 1, 1, 1]))
    assert reg.reader("sc_step_roofline_pct").read(rec) is None
    rec.profiled.matvecs.pop()
    assert reg.reader("sc_step_roofline_pct").read(rec) is not None
    # Idle inside the solve spans: 0.02-0.05, 0.3-0.5, 0.6-0.62, 0.64-0.9,
    # 1.55-1.6, 1.9-1.92, 1.93-1.95 of the 1.36 s idle; the rest is outside.
    assert math.isclose(reg.reader("device_idle_in_solve_pct").read(rec),
                        100 * (0.03 + 0.2 + 0.02 + 0.26 + 0.05 + 0.02 + 0.02) / 2.1)
    box = _record({"lanes": 8, "phase1": 3}, {"n": 24, "dtype": "float32"})
    # Gather 0.36-0.47 and phase 2 0.44-0.8 and 2.05-2.1: 0.49 s of 1.5.
    # No idle interval starts inside the gather span: it counts whole.
    assert math.isclose(reg.reader("phase2_wall_pct").read(box), 100 * 0.49 / 1.5)
    # A gather span from 0.2 waits while the device runs phase 1's kernels
    # to 0.30, where the device falls idle: 0.30-0.8 and 2.05-2.1 count.
    box.trace.spans["ccqppy.gather"] = [[0.2, 0.47]]
    assert math.isclose(reg.reader("phase2_wall_pct").read(box), 100 * 0.55 / 1.5)
    # A gather with no phase 2 after it (no lane past phase 1): from 1.1,
    # where its read returned, to its end.
    box.trace.spans = {"ccqppy.solve": [[1.55, 1.95]], "ccqppy.gather": [[1.0, 1.2]]}
    assert math.isclose(reg.reader("phase2_wall_pct").read(box), 100 * 0.1 / 1.5)
    # Nothing to read: no phase 1 (no compaction), no step kernel, a mix
    # with compaction (smaller batches in phase 2), no peak, no trace.
    assert reg.reader("phase2_wall_pct").read(rec) is None
    assert reg.reader("sc_step_roofline_pct").read(box) is None
    rec.trace.kernel_s = {"add_kernel": 0.1}
    assert reg.reader("sc_step_roofline_pct").read(rec) is None
    assert reg.reader("sc_step_roofline_pct").read(_record({"lanes": 8}, cone, kind="cpu")) is None
    rec.trace = None
    for name in ("sc_step_roofline_pct", "device_idle_in_solve_pct", "phase2_wall_pct"):
        assert reg.reader(name).read(rec) is None


@pytest.mark.parametrize("n,lanes", [(24, 128), (999, 128), (1000, 128), (9999, 1)])
def test_the_checks_chunk(n, lanes):
    assert check.chunk_lanes(n) == lanes
    assert lanes * n * n * 8 <= check.BUDGET or lanes == 1


def _check_records(name):
    """200 answers of a 24-variable ensemble (more lanes than a chunk of 128
    holds): the check's fixed records."""
    cfg = Registry().config(name) | {"n": 24}
    A, b0, _ = traffic.ensemble(cfg, 150, 5, torch.device("cpu"))
    rng = np.random.default_rng(0)
    records = [(k, int(lane), 10, True,
                (traffic.call_rhs(b0, 5, k, 1e-3)[lane] * -0.01).numpy())
               for k in range(2) for lane in rng.permutation(150)[:100]]
    return cfg, A, b0, records


_LIMITS = {"x_gap_max": {"limit": 1.0}, "residual_max": {"limit": 1.0}}


@pytest.mark.parametrize("name,residual,gap,ref_res,steps", [
    ("cone999", 24424.24052789186, 2.311045756919774, 5.903033934548387e-12, 60),
    ("box1000", 1.0780934927901713, 0.6867270867420253, 6.759927956848739e-11, 70)])
def test_the_checks_answers_are_pinned(name, residual, gap, ref_res, steps):
    """The check reads on fixed records, bitwise, what it read with its
    former fixed chunk of 128 lanes (the values it gave then)."""
    cfg, A, b0, records = _check_records(name)
    checks, refused, info = check.judge(cfg, _LIMITS, A, b0, 5, 1e-3, records)
    assert refused == 200 and info == {"lanes": 200, "calls": 2,
                                       "reference_residual_max": ref_res,
                                       "reference_steps_max": steps}
    assert checks["residual_max"]["value"] == residual
    assert checks["x_gap_max"]["value"] == gap


def test_a_smaller_chunk_changes_only_the_references_stop(monkeypatch):
    """At 4 lanes a chunk (a budget of 4 lanes at n = 24) each answer's own
    residual is read bitwise as at 128; the reference stops where its
    chunk's slowest lane is done, so the gap moves by its own tolerance."""
    cfg, A, b0, records = _check_records("box1000")
    wide = check.judge(cfg, _LIMITS, A, b0, 5, 1e-3, records)
    monkeypatch.setattr(check, "BUDGET", 4 * 24 * 24 * 8)
    assert check.chunk_lanes(24) == 4
    narrow = check.judge(cfg, _LIMITS, A, b0, 5, 1e-3, records)
    assert narrow[0]["residual_max"] == wide[0]["residual_max"]
    assert narrow[1] == wide[1] and narrow[2]["lanes"] == wide[2]["lanes"]
    assert narrow[2]["reference_residual_max"] < check.REF_TOL
    assert narrow[0]["x_gap_max"]["value"] != wide[0]["x_gap_max"]["value"]
    assert math.isclose(narrow[0]["x_gap_max"]["value"], wide[0]["x_gap_max"]["value"],
                        rel_tol=1e-9)