"""A loop's flag on the device (``ops/loop_flag.py``, ``csrc/loop_flag.cu``).

CPU: the plain version, the arguments the wrapper refuses and the host's
read of a written flag (``models.base.host_flag``).  Card (marked
``cuda``): the kernel against the plain version at widths below, at and
above one block's threads, into device memory and into pinned host memory
(which the host reads with no call into CUDA), and a launch captured in a
CUDA graph counted once a replay.
"""
import pytest
import torch

from ccqppy_tpu_torch.models import base
from ccqppy_tpu_torch.ops import kernels, loop_flag


@pytest.mark.parametrize("running", [0, 1, 5], ids=["none", "one", "five"])
def test_the_flag_says_whether_a_lane_runs(running):
    done = torch.ones(9, dtype=torch.bool)
    done[:running] = False
    out = torch.full((1,), 7, dtype=torch.int64)
    loop_flag.running(done, out)
    assert out.tolist() == [int(running > 0)]


@pytest.mark.parametrize("bad", ["done_dtype", "done_shape", "out_dtype", "out_size"])
def test_the_flag_refuses_bad_arguments(bad):
    done = torch.zeros(4, dtype=torch.bool)
    out = torch.zeros(1, dtype=torch.int64)
    if bad == "done_dtype":
        done = done.int()
    elif bad == "done_shape":
        done = done[None]
    elif bad == "out_dtype":
        out = out.int()
    else:
        out = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="must be"):
        loop_flag.running(done, out)


@pytest.mark.parametrize("value", [0, 1])
def test_host_flag_reads_a_written_flag(value):
    """A flag that is written (not -1) is read at once, and counted."""
    flags = torch.tensor([-1, value], dtype=torch.int64)
    syncs = base.HOST_SYNCS
    assert base.host_flag(flags.numpy(), 1, flags.device) == value
    assert base.HOST_SYNCS == syncs + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 256, 1000, 3001])
def test_the_flag_kernel_is_its_plain_version(B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    gen = torch.Generator().manual_seed(B)
    for lane in (None, 0, B - 1, int(torch.randint(B, (1,), generator=gen))):
        done = torch.ones(B, dtype=torch.bool, device=dev)
        if lane is not None:
            done[lane] = False
        before = loop_flag.LAUNCHES
        loop_flag.running(done, out)
        assert out.tolist() == [int(lane is not None)] and loop_flag.LAUNCHES == before + 1
    # Captured in a graph: the launch runs, and counts, once a replay.
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream), kernels.graph_capture() as replayed:
        graph.capture_begin()
        loop_flag.running(done, out)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    before = loop_flag.LAUNCHES
    done.fill_(True)
    graph.replay()
    replayed()
    assert out.tolist() == [0] and loop_flag.LAUNCHES == before + 1
    # Into pinned host memory, eagerly and from a graph: the host reads each
    # write once it lands, with no call into CUDA.
    flags = torch.full((2,), -1, dtype=torch.int64, pin_memory=True)
    values = flags.numpy()
    done[B // 2] = False
    loop_flag.running(done, flags[1])
    assert base.host_flag(values, 1, dev) == 1 and values[0] == -1
    pinned_graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        pinned_graph.capture_begin()
        loop_flag.running(done, flags[0])
        pinned_graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    for running in (True, False):
        done[B // 2] = not running
        values[0] = -1
        pinned_graph.replay()
        assert base.host_flag(values, 0, dev) == int(running)
    with pytest.raises(ValueError, match="pinned host memory"):
        loop_flag.running(done, torch.zeros((), dtype=torch.int64))
