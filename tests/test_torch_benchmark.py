"""The port's timing guard (ccqppy_tpu_torch.utils.benchmark), mirroring
tests/test_benchmark_guard.py: a wall implying far more than the H100's
device-memory peak is rejected, a plausible one accepted."""
import numpy as np
import pytest
import torch

from ccqppy_tpu_torch.models.base import make_result
from ccqppy_tpu_torch.utils.benchmark import (PEAK_HBM_BYTES_PER_S, TimedRun,
                                              dense_sweep_bytes, materialize,
                                              timed_run)

torch.set_num_threads(1)


def test_materialize_covers_every_tensor():
    r = make_result(torch.arange(4.0)[None], torch.tensor([0.5]),
                    torch.tensor([3]), torch.tensor([2]), 10)
    # x 0+1+2+3, residual 0.5, converged 1, matvecs 3, iterations 2
    assert materialize((r, [torch.ones(2, 2)])) == pytest.approx(6.5 + 1 + 3 + 2 + 4)


def test_guard_rejects_physically_impossible_wall():
    with pytest.raises(RuntimeError, match="roofline"):
        timed_run(lambda x: x + 1, torch.zeros(8), reps=3, implied_bytes=1e15)


def test_guard_rejects_a_leaked_fence_at_bench_scale():
    # One iterative call moves at least 10 sweeps of B=2048 n=1000 Hessians:
    # 82 GB, which no H100 reads in under 12 ms.
    bytes_ = dense_sweep_bytes(2048, 1000, 10)
    assert bytes_ / 0.001 > 2 * PEAK_HBM_BYTES_PER_S
    with pytest.raises(RuntimeError):
        timed_run(lambda x: x * 2.0, torch.zeros(16), reps=2, implied_bytes=bytes_)


def test_plausible_measurement_accepted():
    out = timed_run(lambda v: torch.cumsum(v, 0), torch.arange(1000.0), reps=2,
                    implied_bytes=8000)
    assert isinstance(out, TimedRun)
    assert out.wall_s > 0 and len(out.walls) == 2 and not out.rejected
    assert out.result.shape == (1000,) and out.implied_gbps is not None


def test_make_args_and_check_see_every_rep():
    seen, checked = [], []

    def make(rep):
        seen.append(rep)
        return (torch.full((4,), float(rep)),)

    out = timed_run(lambda v: v + 1, reps=2, make_args=make,
                    check=lambda r: checked.append(float(r[0])))
    assert seen == [-1, 0, 1]                   # warm-up + 2 reps
    assert checked == [1.0, 2.0]                # the timed reps only
    np.testing.assert_allclose(out.result.numpy(), 2.0)


def _scripted_device_ms(monkeypatch, reps_out, reps):
    """``device_ms`` with its card parts replaced: each rep returns the next
    (device ms, host ms, spin ms) of ``reps_out``; returns the spins asked
    for."""
    from ccqppy_tpu_torch.utils import benchmark
    asked = []
    script = iter(reps_out)

    def held(fn, cycles):
        asked.append(cycles)
        return next(script)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(benchmark, "_spin_cycles_per_ms", lambda device: 1000.0)
    monkeypatch.setattr(benchmark, "_held_rep", held)
    return benchmark.device_ms(lambda: None, reps=reps, warmup=1), asked


def test_device_ms_keeps_only_reps_enqueued_within_their_spin(monkeypatch):
    """A rep whose host enqueue outlasted its spin is never kept: it is
    taken again behind a spin twice as long."""
    ms, asked = _scripted_device_ms(
        monkeypatch, [(1.0, 0.5, 1.0), (9.0, 1.5, 1.0), (2.0, 0.5, 2.0), (3.0, 0.5, 2.0)], 3)
    assert ms == 2.0
    assert asked[1] == asked[0] and asked[2] == 2 * asked[0] and asked[3] == asked[2]
    assert asked[0] >= 1000.0     # MIN_SPIN_S at 1000 cycles a ms


def test_device_ms_raises_when_no_rep_is_clean(monkeypatch):
    from ccqppy_tpu_torch.utils import benchmark
    stalled = [(1.0, 5.0, 1.0)] * benchmark.HELD_RETRIES
    with pytest.raises(RuntimeError, match="host time"):
        _scripted_device_ms(monkeypatch, [(1.0, 0.5, 1.0)] + stalled, 2)
