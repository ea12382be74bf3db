"""The one general generator: a cell's ensemble and its stream of calls,
made on the device from ``--seed``.

The ensemble follows the configuration file: ``A = G G^T + diag_boost n I``
(``G`` an n x n standard normal, a Wishart(n, I) draw), the unconstrained
optimum ``x ~ U(low, high)^n`` and ``b0 = -A x``.  It is a frozen copy of
the program's ``random_qp_batch`` (same draws in the same order from a
``torch.Generator`` on the device, in chunks of 256 lanes so that the
factor ``G`` never doubles the footprint of A), kept here so that the
yardstick does not move with the program.

The problems are one draw, from the configuration's ``pool_seed``; the
run's seed puts its lanes in an order of its own.  A call's cost is set by
its slowest lanes, and those differ from one draw of the ensemble to the
next by more than two runs of one draw differ: with the pool fixed, every
seed has the same work, in another order.

Call ``k`` of a run solves the ensemble with ``b = b0 + noise N(0, 1)``,
the noise drawn on the device from a generator seeded by ``(seed, k)``:
the check draws the same ``b`` again after the window.  The warm-up call
is ``k = -1``.

``Sampler`` picks, from the seed, the lanes whose answers the check judges:
a uniform sample of every call's lanes, and the lanes that took the most
matvecs (the stragglers), each of a fixed size.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

CHUNK = 256
_MASK = (1 << 64) - 1


def dtype_of(config):
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


def mix64(*words):
    """A 64-bit hash of whole numbers (splitmix64 steps): the seeds of the
    ensemble, of each call's noise and of the sampler, all from ``--seed``."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK)) & _MASK
        h = (h + 0x9E3779B97F4A7C15) & _MASK
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK
        h ^= h >> 31
    return h


def ensemble(config, lanes, seed, device):
    """The cell's ensemble: A (lanes, n, n), b0 (lanes, n), x_uncon (lanes, n):
    the configuration's pool, its lanes in the order of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(config["pool_seed"]))
    order = torch.randperm(lanes, generator=torch.Generator(device=device).manual_seed(
        mix64(seed, 1)), device=device)
    return draw(config, lanes, gen, order=order)


def draw(config, lanes, gen, chunk=CHUNK, order=None):
    """The ensemble's draws from the generator ``gen``, on its device; draw
    i lands in lane ``order[i]`` (default i)."""
    n, dtype, device = int(config["n"]), dtype_of(config), gen.device
    hess, opt = config["hessian"], config["optimum"]
    if hess["kind"] != "wishart_shifted" or opt["kind"] != "uniform":
        raise ValueError(f"unknown draws {hess['kind']!r} / {opt['kind']!r}")
    boost, low, high = float(hess["diag_boost"]), float(opt["low"]), float(opt["high"])
    A = torch.empty((lanes, n, n), dtype=dtype, device=device)
    b = torch.empty((lanes, n), dtype=dtype, device=device)
    x = torch.empty((lanes, n), dtype=dtype, device=device)
    order = torch.arange(lanes, device=device) if order is None else order
    for i in range(0, lanes, chunk):
        c = min(chunk, lanes - i)
        G = torch.randn((c, n, n), generator=gen, dtype=dtype, device=device)
        Ac = torch.bmm(G, G.transpose(1, 2))
        del G
        if boost:
            Ac.diagonal(dim1=-2, dim2=-1).add_(boost * n)
        xc = (high - low) * torch.rand((c, n), generator=gen, dtype=dtype, device=device) + low
        lanes_c = order[i:i + c]
        A.index_copy_(0, lanes_c, Ac)
        x.index_copy_(0, lanes_c, xc)
        b.index_copy_(0, lanes_c, -torch.bmm(Ac, xc[:, :, None])[..., 0])
        del Ac
    return A, b, x


def call_rhs(b0, seed, k, noise):
    """The right-hand sides of call ``k``: ``b0 + noise N(0, 1)`` drawn on
    ``b0``'s device from ``(seed, k)``."""
    gen = torch.Generator(device=b0.device).manual_seed(mix64(seed, 2, k))
    return b0 + noise * torch.randn(b0.shape, generator=gen, dtype=b0.dtype, device=b0.device)


class Sampler:
    """The lanes the check judges, drawn from the seed as the calls come.

    ``uniform``: a reservoir (Algorithm R) over ``uniform_per_call`` lanes
    drawn from each call; ``longest``: the ``longest`` lanes with the most
    matvecs among each call's ``longest_per_call`` slowest, ties broken by
    a draw.  Each kept lane holds its call index, lane, matvecs, converged
    flag and its answer ``x`` as the host received it."""

    def __init__(self, spec, seed):
        self.spec = spec
        self.rng = np.random.default_rng(mix64(seed, 3))
        self.uniform, self.seen = [], 0
        self.longest = []     # min-heap of (matvecs, tie draw, record)

    def offer(self, k, x, converged, matvecs):
        s = self.spec
        B = matvecs.shape[0]
        for lane in self.rng.integers(0, B, size=int(s["uniform_per_call"])):
            self.seen += 1
            rec = (k, int(lane), int(matvecs[lane]), bool(converged[lane]), x[lane].copy())
            if len(self.uniform) < s["uniform"]:
                self.uniform.append(rec)
            else:
                j = int(self.rng.integers(0, self.seen))
                if j < s["uniform"]:
                    self.uniform[j] = rec
        m = min(int(s["longest_per_call"]), B)
        top = np.argpartition(-matvecs, m - 1)[:m] if m < B else np.arange(B)
        for lane in top:
            item = (int(matvecs[lane]), float(self.rng.random()))
            if len(self.longest) >= s["longest"] and item <= self.longest[0][:2]:
                continue
            rec = (k, int(lane), int(matvecs[lane]), bool(converged[lane]), x[lane].copy())
            entry = (*item, rec)
            if len(self.longest) < s["longest"]:
                heapq.heappush(self.longest, entry)
            else:
                heapq.heapreplace(self.longest, entry)

    def records(self):
        """Every kept lane once: (call, lane, matvecs, converged, x)."""
        out, seen = [], set()
        for rec in self.uniform + [e[2] for e in self.longest]:
            if (rec[0], rec[1]) not in seen:
                seen.add((rec[0], rec[1]))
                out.append(rec)
        return out
