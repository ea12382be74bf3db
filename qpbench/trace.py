"""From a ``torch.profiler`` trace of the profiled calls to numbers.

The benchmark marks its own calls into the entry with
``record_function`` spans (``CALL_SPAN`` around the entry's call,
``FETCH_SPAN`` around the copy of the answers to the host).  The traced
window runs from the first call span's start to the last fetch span's end.
Within it:

* busy: the union of the intervals in which an operation ran on the device
  (kernels, copies, fills; not the device-side copies of the spans, which
  the profiler lists with the device's events); idle share = 1 - busy /
  window;
* kernels: device operations other than copies (``Memcpy``) and fills
  (``Memset``); the GEMV's are those whose name holds ``GEMV_NAME``;
* idle gaps: the stretches between busy intervals, each named by the
  innermost host operation or span running at its middle (``LOOP``, the
  caller's own bookkeeping between calls, where none runs), summed by name.

For the readers of single kernels and of the program's own spans it also
keeps, clipped to the window: each kernel's device seconds and launches by
its full name (``kernel_s``, ``kernel_launches``); the merged intervals of
each host span the program names with ``SPAN_PREFIX`` (``spans``, by
name); and the device's idle intervals (``idle``).  ``merged`` and
``overlap`` work on such interval lists.

The reduction takes plain lists of ``(name, start_s, end_s)``, so it is
tested without a card.
"""
from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from dataclasses import dataclass

CALL_SPAN = "qpbench.call"
FETCH_SPAN = "qpbench.fetch"
DRAW_SPAN = "qpbench.draw"
GEMV_NAME = "batched_gemv"
#: The program names its spans ``ccqppy.<stage>`` (``models.base.span``).
SPAN_PREFIX = "ccqppy."
TOP = 10
NAME_CHARS = 120
LOOP = "caller loop"


def profiler_events(events):
    """(device ops, host ops) of a finished ``torch.profiler.profile``'s
    events (``prof.events()``), each a list of (name, start_s, end_s)."""
    from torch.autograd import DeviceType

    dev, host, spans = [], [], {CALL_SPAN, FETCH_SPAN, DRAW_SPAN}
    for e in events:
        item = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        annotation = getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CUDA:
            if not annotation:
                dev.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
            if annotation:
                spans.add(e.name)
    # A span's device-side copy (a user annotation) is no operation.
    return [d for d in dev if d[0] not in spans], host


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def overlap(a, b):
    """Total length shared by two sorted, disjoint lists of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    gemv_s: float
    other_kernel_s: float
    device_ops: list      # [[name, seconds]], the TOP largest
    idle_gaps: list       # [[name, seconds]], the TOP largest
    kernel_s: dict        # kernel name -> device seconds
    kernel_launches: dict  # kernel name -> launches
    spans: dict           # program span name -> merged [[start, end]]
    idle: list            # the device's idle intervals, [[start, end]]

    @property
    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s


def _label_points(points, host):
    """For each time in ``points`` (sorted), the name of the innermost host
    op running then: the latest-started one of those that contain it."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    active = []          # max-heap on start: (-start, end, name)
    out, j = [], 0
    for t in points:
        j2 = bisect.bisect_right(starts, t, lo=j)
        for name, s, e in host[j:j2]:
            heapq.heappush(active, (-s, e, name))
        j = j2
        while active and active[0][1] < t:
            heapq.heappop(active)
        # An op that ended before t but started later than a live one sits
        # below it in the heap and is dropped when it surfaces; the live top
        # is then the innermost op that contains t.
        out.append(active[0][2] if active else LOOP)
    return out


def summarize(dev, host, calls):
    """Reduce one traced window of ``calls`` calls; None when no call span
    or no device operation is in it."""
    spans = [h for h in host if h[0] in (CALL_SPAN, FETCH_SPAN)]
    if not spans or not dev:
        return None
    w0 = min(s for n, s, _ in spans if n == CALL_SPAN)
    w1 = max(e for n, _, e in spans if n == FETCH_SPAN) if any(
        n == FETCH_SPAN for n, _, _ in spans) else max(e for _, _, e in spans)
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    if not inside:
        return None
    busy = merged((s, e) for _, s, e in inside)
    busy_s = sum(e - s for s, e in busy)
    kernels = [(n, s, e) for n, s, e in inside if is_kernel(n)]
    gemv = [(n, s, e) for n, s, e in kernels if GEMV_NAME in n]
    by_op = defaultdict(float)
    for n, s, e in inside:
        by_op[n[:NAME_CHARS]] += e - s
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    labels = _label_points([(a + b) / 2 for a, b in gaps],
                           [h for h in host if h[2] > w0 and h[1] < w1])
    by_gap = defaultdict(float)
    for (a, b), name in zip(gaps, labels):
        by_gap[name[:NAME_CHARS]] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    kernel_s, launches = defaultdict(float), defaultdict(int)
    for n, s, e in kernels:
        kernel_s[n] += e - s
        launches[n] += 1
    spans = defaultdict(list)
    for n, s, e in host:
        if n.startswith(SPAN_PREFIX) and e > w0 and s < w1:
            spans[n].append((max(s, w0), min(e, w1)))
    return TraceSummary(
        window_s=w1 - w0, busy_s=busy_s, kernels=len(kernels),
        gemv_s=sum(e - s for _, s, e in gemv),
        other_kernel_s=sum(e - s for n, s, e in kernels if GEMV_NAME not in n),
        device_ops=top(by_op), idle_gaps=top(by_gap),
        kernel_s=dict(kernel_s), kernel_launches=dict(launches),
        spans={n: merged(v) for n, v in spans.items()}, idle=[[a, b] for a, b in gaps])
