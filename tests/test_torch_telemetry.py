"""The port's telemetry on the CPU: the host-sync counter against the
profiler's own record of host reads, the compaction spans and their
nesting, spans absent without a profiler, and the spans in
``profile_solve``'s chrome trace."""
import json
import os

import pytest
import torch

from ccqppy_tpu_torch.models import SOLVERS, base
from ccqppy_tpu_torch.ops.projections import blockwise, box, lorentz_cone
from ccqppy_tpu_torch.parallel import batch
from ccqppy_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

B, N = 8, 18
PHASE1, BUCKET = 4, 3
#: The profiler's names for a host read of a device value: ``bool(t)``
#: (through ``item``) and ``nonzero``, which reads its output's size.
SYNC_EVENTS = ("aten::_local_scalar_dense", "aten::nonzero")


def _problem(seed=5):
    g = torch.Generator().manual_seed(seed)
    G = torch.randn((B, N, N), generator=g, dtype=torch.float64)
    A = G @ G.transpose(1, 2) + N * torch.eye(N, dtype=torch.float64)
    xu = 2.0 * torch.rand((B, N), generator=g, dtype=torch.float64) - 1.0
    return A, -torch.einsum("bij,bj->bi", A, 2.0 * xu)


def _set(kind):
    if kind == "box":
        return box(-torch.ones(N), torch.ones(N), dtype=torch.float64)
    return blockwise(lorentz_cone(1.0, dtype=torch.float64), 3)


def _config(solver):
    return SOLVERS[solver][1](tol=1e-6, max_matvecs=120)


def _solver_call(solver):
    return lambda A, b, proj: SOLVERS[solver][0](A, b, proj=proj, config=_config(solver))


ENTRIES = {
    "solve_batched": lambda A, b, proj: batch.solve_batched(
        "pcg", A, b, proj=proj, config=_config("pcg")),
    "solve_batched_compact": lambda A, b, proj: batch.solve_batched_compact(
        "pcg", A, b, PHASE1, proj=proj, config=_config("pcg")),
    "solve_batched_fused_compact": lambda A, b, proj: batch.solve_batched_fused_compact(
        "pcg", A, b, PHASE1, proj=proj, config=_config("pcg"), bucket=BUCKET),
}
CASES = [pytest.param(_solver_call(s), k, id=f"{s}-{k}") for s in SOLVERS
         for k in ("box", "cone")] + \
    [pytest.param(fn, k, id=f"{name}-{k}") for name, fn in ENTRIES.items()
     for k in ("box", "cone")]


def _profiled(call, *args):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r = call(*args)
    return r, prof.events()


@pytest.mark.parametrize("call,kind", CASES)
def test_host_syncs_count_every_host_read_the_profiler_sees(call, kind):
    A, b = _problem()
    proj = _set(kind)
    before = base.HOST_SYNCS
    r, events = _profiled(call, A, b, proj)
    counted = base.HOST_SYNCS - before
    seen = sum(e.name in SYNC_EVENTS for e in events)
    assert counted > 0 and counted == seen
    assert bool(r.converged.any())


def _spans(events):
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith("ccqppy.")), key=lambda s: s[1])


def test_fused_compaction_spans_nest_in_order():
    A, b = _problem()
    r, events = _profiled(ENTRIES["solve_batched_fused_compact"], A, b, _set("box"))
    # Stragglers past the bucket: phase 2 ran and the fallback finished them.
    assert bool((r.matvecs > PHASE1).any()) and bool(r.converged.all())
    spans = _spans(events)
    names = [n for n, _, _ in spans]
    assert names[:4] == ["ccqppy.solve", "ccqppy.phase1", "ccqppy.gather", "ccqppy.phase2"]
    assert names.count("ccqppy.solve") == 1 and names.count("ccqppy.fallback") == 1
    (_, s0, e0), rest = spans[0], spans[1:]
    assert all(s0 <= s and e <= e0 for _, s, e in rest)
    (_, p1s, p1e), (_, gs, ge), (_, p2s, p2e) = spans[1:4]
    assert p1e <= gs and ge <= p2s


def test_nested_entries_record_one_solve_span():
    A, b = _problem()
    _, events = _profiled(ENTRIES["solve_batched_compact"], A, b, _set("box"))
    names = [n for n, _, _ in _spans(events)]
    assert names.count("ccqppy.solve") == 1 and names[:2] == ["ccqppy.solve", "ccqppy.phase1"]


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    A, b = _problem()
    for call in ENTRIES.values():
        call(A, b, _set("box"))
    with pytest.raises(AssertionError):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            ENTRIES["solve_batched"](A, b, _set("box"))


def test_profile_solve_trace_holds_the_spans(tmp_path):
    A, b = _problem()
    with diagnostics.profile_solve(str(tmp_path)):
        ENTRIES["solve_batched_fused_compact"](A, b, _set("box"))
    with open(os.path.join(tmp_path, diagnostics.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ccqppy.solve", "ccqppy.phase1", "ccqppy.gather", "ccqppy.phase2",
            "ccqppy.fallback"} <= names
