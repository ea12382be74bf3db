"""What the hand-written kernels' wrappers share (``ops/step_common.py``,
``ops/kernels.py``), one case per kernel: the library carries each fused
step's entry points, each step refuses CPU tensors without counting a
launch, each checks its state through one table, and a launch recorded
while a CUDA graph captures counts once a replay.  CPU only."""
import pytest
import torch

from ccqppy_tpu_torch.models import base, mprgp
from ccqppy_tpu_torch.ops import gemv, kernels, mprgp_step, sc_step, step_common
from ccqppy_tpu_torch.ops.projections import blockwise, lorentz_cone

#: Each step kernel's source (``csrc/<name>.cu``) -> its entry points.
ENTRY_POINTS = {"apgd_sc_step": {f"apgd_sc_step_{k}_{t}" for k in ("lorentz", "box")
                                 for t in ("f32", "f64")},
                "mprgp_step": {"mprgp_step_lorentz_f32", "mprgp_step_lorentz_f64"}}


@pytest.mark.parametrize("step", list(ENTRY_POINTS))
def test_library_carries_the_step(step):
    assert ENTRY_POINTS[step] <= set(kernels.SIGNATURES)
    assert f"{step}.cu" in [s.name for s in kernels.sources()]


def _state(step, B=2, n=6):
    """(module, its calls on a small f32 CPU state, its ``_check``, b, the
    state's groups as ``_check`` takes them, the step's name in errors)."""
    z = torch.zeros((B, n))
    lane = torch.zeros(B)
    ints, flags = torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.bool)
    sargs = step_common.set_args(blockwise(lorentz_cone(1.0), 3), z)
    if step == "apgd_sc_step":
        calls = [lambda: sc_step.step(sargs, z.clone(), z, z.clone(), z.clone(), z.clone(),
                                      lane.clone(), ints.clone(), ints.clone(), flags.clone(),
                                      flags.clone(), lane + 1, lane, tol=1e-5, gd=1e-6,
                                      budget=10, restart=True)]
        return sc_step, calls, z, [(z,), (lane, lane[:, None]), (ints,), (flags,)], "apgd_sc"
    s = mprgp._FusedState(z, z.clone(), z.clone(), z.clone(), z.clone(), lane + 1, flags,
                          flags.clone(), lane.clone(), ints.clone(), ints.clone(),
                          flags.clone(), z[:, :0])
    calls = [lambda: mprgp_step.operand(sargs, z, s, z.clone(), z.double(), flags.clone(),
                                        gamma2=1.0),
             lambda: mprgp_step.step(sargs, z.double(), z, s, z.clone(), z.double(),
                                     flags.clone(), tol=1e-5, budget=10, gamma2=1.0,
                                     tiny=1e-6)]
    return mprgp_step, calls, z, [(z,), (z.double(),), (lane,), (ints,), (flags,)], "MPRGP"


@pytest.mark.parametrize("step", list(ENTRY_POINTS))
def test_step_refuses_cpu_tensors(step):
    module, calls, *_ = _state(step)
    before = module.LAUNCHES
    for call in calls:
        with pytest.raises(ValueError, match="runs on cuda"):
            call()
    assert module.LAUNCHES == before


@pytest.mark.parametrize("step", list(ENTRY_POINTS))
def test_state_check_refuses_each_group(step):
    """Each group of the state is held to its dtype and shapes, and b to f32
    or f64; the error names the step."""
    module, _, b, groups, name = _state(step)
    module._check(b, *groups)
    for k, group in enumerate(groups):
        for bad in (group[-1].to(torch.float16), group[-1][:1]):
            with pytest.raises(ValueError, match=f"the fused {name} step takes contiguous"):
                module._check(b, *groups[:k], (*group[:-1], bad), *groups[k + 1:])
    with pytest.raises(TypeError, match=f"the fused {name} step takes f32 or f64"):
        module._check(b.half(), *groups)


def counters():
    """The GEMV's launch counters by instance and its lanes swept, the MPRGP
    step's launches, the host syncs and MPRGP's passes."""
    return (gemv.LAUNCHES, gemv.LAUNCHES_BF16, gemv.LAUNCHES_F64, gemv.LAUNCHES_F32_F64,
            gemv.LANES_SWEPT, mprgp_step.LAUNCHES, base.HOST_SYNCS, mprgp.MPRGP_ITERS)


@pytest.mark.parametrize("kernel", ["gemv", "mprgp_step"])
def test_a_captured_launch_counts_once_a_replay(kernel):
    """A launch recorded while a CUDA graph captures runs only when the
    graph replays: the capture counts nothing, and each call of the function
    ``kernels.graph_capture`` yields counts it once (the GEMV's by instance
    and lanes)."""
    c0 = counters()
    with kernels.graph_capture() as replayed:
        if kernel == "gemv":
            # What ``batched_gemv`` counts of an (f32 A, f64 x) launch at B = 3.
            kernels.count(gemv._count, torch.float32, torch.float64, 3)
        else:
            kernels.count(mprgp_step._count)
    assert counters() == c0 and kernels._captured is None
    replayed()
    replayed()
    want = [2, 0, 0, 2, 6, 0, 0, 0] if kernel == "gemv" else [0, 0, 0, 0, 0, 2, 0, 0]
    assert [c - c_0 for c, c_0 in zip(counters(), c0)] == want
