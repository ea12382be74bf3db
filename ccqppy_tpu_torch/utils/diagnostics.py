"""Observability and debugging utilities.

Port of ``ccqppy_tpu/utils/diagnostics.py``:

* ``timed_solve``   -- wall-clock timing of one solver call, closed by
                       ``utils.benchmark.synchronize``, written into every
                       lane of ``SolveResult.solve_time``.
* ``trim_trace``    -- every solver records its per-iteration Eq. 25
                       residual when ``config.trace_len > 0``; this cuts the
                       NaN tail of each lane.
* ``profile_solve`` -- ``torch.profiler`` around a block of solves, CUDA
                       activity included when the process has a card; the
                       chrome trace lands in ``log_dir``.
* ``check_result``  -- host-side postcondition report: finiteness,
                       feasibility, residual consistency (raises with a
                       readable report).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ccqppy_tpu_torch.models.base import pg_residual
from ccqppy_tpu_torch.utils.benchmark import synchronize

#: File name of ``profile_solve``'s chrome trace inside ``log_dir``
#: (TensorBoard's PyTorch plugin reads ``*.pt.trace.json``).
TRACE_FILE = "solve.pt.trace.json"


def timed_solve(fn, *args, **kwargs):
    """Run ``fn`` (a solver call) and fill ``solve_time`` with wall seconds,
    the same on every lane (one call solves the whole batch).  The first
    call on CUDA includes the kernels' build; call twice to measure steady
    state."""
    synchronize((args, list(kwargs.values())))
    t0 = time.perf_counter()
    r = fn(*args, **kwargs)
    synchronize(r.x)
    elapsed = time.perf_counter() - t0
    return dataclasses.replace(r, solve_time=torch.full_like(r.solve_time, elapsed))


@contextlib.contextmanager
def profile_solve(log_dir):
    """``torch.profiler`` trace around a block of solves::

        with profile_solve("/tmp/trace") as prof:
            solve(...)

    Records CPU activity, and CUDA activity when a card is present; on
    exit writes the chrome trace to ``log_dir/TRACE_FILE``.  Yields the
    profiler, whose ``key_averages()`` sums time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(str(log_dir), TRACE_FILE))


def trim_trace(result):
    """The recorded residual history of every lane without its unused NaN
    tail: a list of per-lane arrays (lanes stop at different iterations)."""
    tr = result.trace.detach().cpu().numpy()
    return [row[~np.isnan(row)] for row in tr]


def _gradient(A, x, b):
    """A x + b per lane by a plain ``einsum`` in ``promote(A, x)``, not the
    solvers' operator path: an audit independent of the GEMV kernel.  On
    CUDA an f32 product would run in TF32 with
    ``torch.backends.cuda.matmul.allow_tf32`` on, and then this raises."""
    acc = torch.promote_types(A.dtype, x.dtype)
    if A.is_cuda and acc == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("check_result needs IEEE f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.einsum("bij,bj->bi", A.to(acc), x.to(acc)) + b.to(acc)


def check_result(result, proj=None, A=None, b=None, gd=1e-6, raise_on_fail=True):
    """Postcondition sanity report for a ``SolveResult`` (B lanes).

    Checks:
    * solution and residual are finite;
    * every lane's iterate is feasible under ``proj`` (``proj.contains``);
    * the reported residual matches a recomputation from (A, b) (when
      given): A a (B, n, n) tensor (or one (n, n) matrix shared by every
      lane), b (B, n), on the result's device.

    Returns a dict report; raises AssertionError on failure unless
    ``raise_on_fail=False``.
    """
    report = {}
    x = result.x
    report["finite_x"] = bool(torch.isfinite(x).all())
    report["finite_residual"] = bool(torch.isfinite(result.residual).all())

    if proj is not None:
        feas = proj.contains(x).tolist()
        report["feasible"] = all(feas)
        report["infeasible_lanes"] = [i for i, f in enumerate(feas) if not f]

    if A is not None and b is not None and proj is not None:
        A = torch.as_tensor(A, device=x.device)
        b = torch.as_tensor(b, device=x.device)
        if A.dim() == 2:
            A = A.expand(x.shape[0], *A.shape)
        g = _gradient(A, x, b)
        recomputed = pg_residual(proj, x.to(g.dtype), g, gd).double().cpu().numpy()
        reported = result.residual.double().cpu().numpy()
        denom = np.maximum(np.abs(recomputed), 1e-30)
        report["residual_rel_err"] = float(
            np.max(np.abs(recomputed - reported) / np.maximum(denom, 1.0)))
        report["residual_consistent"] = bool(report["residual_rel_err"] < 1e-2)

    ok = all(v for k, v in report.items() if isinstance(v, bool))
    report["ok"] = ok
    if raise_on_fail and not ok:
        raise AssertionError(f"SolveResult check failed: {report}")
    return report
