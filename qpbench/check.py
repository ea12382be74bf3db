"""How ``correct`` is decided: the sampled answers of the window against the
plain reference, once the window has closed.

For every lane the sampler kept (call k, lane i, the answer x the host
received), the check draws call k's right-hand side again from the seed,
takes lane i's Hessian from the benchmark's own ensemble, and works out in
f64:

* ``residual_max``: the largest Eq. 25 residual of the answers, with a
  fresh f64 gradient ``A x + b``; the configuration states its limit, tol
  times its audit margin.  An answer outside the set reads far above it;
* ``x_gap_max``: the largest ``||x - x_ref|| / ||x_ref||``, x_ref the
  reference's projected-gradient optimum of the same lane at residual
  1e-10; its limit is the cell's (``checks/<cell>.json``), set from the
  readings of sound runs and of the TF32 control.

The flag a lane reports does not matter here: an unconverged lane is judged
as any other.  A number whose limit is missing fails.  The lanes go to f64
in chunks of ``chunk_lanes(n)``: 128 up to n = 1000, fewer above (one at
n = 9999, 0.8 GB).  The reference steps a chunk until its slowest lane is
done, so the chunk's size is part of every reading.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from qpbench import traffic
from qpbench.reference import sets, solve

CHUNK = 128                   # lanes in f64 at once, at most
BUDGET = CHUNK * 1000 ** 2 * 8   # bytes of A in f64 at once (1 GB: 128 lanes at n = 1000)
REF_TOL = 1e-10               # the reference optimum's own Eq. 25 residual


def chunk_lanes(n):
    """Lanes of an (n, n) ensemble the check holds in f64 at once."""
    return min(CHUNK, max(1, BUDGET // (n * n * 8)))


def limits(config, cell_checks):
    """The limit of each compared number."""
    return {"residual_max": config["tol"] * config["guarantee"]["audit_margin"],
            "x_gap_max": cell_checks.get("x_gap_max", {}).get("limit")}


def judge(config, cell_checks, A, b0, seed, noise, records):
    """Judge the sampled answers.  Returns (checks, refused, info): checks
    maps each compared number to {"value", "limit"}, refused counts the
    lanes that break a limit, info holds the reference's own readings."""
    spec, gd = config["set"], float(config["gd"])
    tols = {"rtol": float(config["guarantee"]["active_rtol"]),
            "atol": float(config["guarantee"]["active_atol"])}
    lim = limits(config, cell_checks)
    by_call = defaultdict(list)
    for rec in records:
        by_call[rec[0]].append(rec)
    device = A.device
    lanes, bs, xs = [], [], []
    for k in sorted(by_call):
        recs = by_call[k]
        idx = torch.tensor([r[1] for r in recs], device=device)
        bs.append(traffic.call_rhs(b0, seed, k, noise).index_select(0, idx).double())
        lanes.append(idx)
        xs.extend(r[4] for r in recs)
    if not xs:
        nan = {"value": math.nan}
        return ({k: {**nan, "limit": v} for k, v in lim.items()}, 0,
                {"lanes": 0})
    lanes, b = torch.cat(lanes), torch.cat(bs)
    x = torch.from_numpy(np.stack(xs)).to(device=device, dtype=torch.float64)
    res, gap, ref_res, ref_steps = [], [], [], 0
    chunk = chunk_lanes(A.shape[-1])
    for i in range(0, x.shape[0], chunk):
        A64 = A.index_select(0, lanes[i:i + chunk]).double()
        xi, bi = x[i:i + chunk], b[i:i + chunk]
        res.append(sets.pg_residual(spec, xi, solve.bmv(A64, xi) + bi, gd, **tols))
        x_ref, r_ref, steps = solve.solve(A64, bi, spec, gd, tol=REF_TOL)
        gap.append(torch.linalg.vector_norm(xi - x_ref, dim=-1)
                   / torch.linalg.vector_norm(x_ref, dim=-1).clamp_min(1e-300))
        ref_res.append(r_ref)
        ref_steps = max(ref_steps, steps)
        del A64
    res, gap = torch.cat(res).cpu().numpy(), torch.cat(gap).cpu().numpy()
    values = {"residual_max": float(res.max()), "x_gap_max": float(gap.max())}
    bad = np.zeros(res.shape, bool)
    for name, per_lane in (("residual_max", res), ("x_gap_max", gap)):
        bad |= ~(per_lane <= (lim[name] if lim[name] is not None else -math.inf))
    checks = {k: {"value": values[k], "limit": lim[k]} for k in lim}
    info = {"lanes": int(res.shape[0]), "calls": len(by_call),
            "reference_residual_max": float(torch.cat(ref_res).max()),
            "reference_steps_max": ref_steps}
    return checks, int(bad.sum()), info


def passed(checks):
    """True when every number has a limit and is at most it."""
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
