"""Per-lane random streams: the port's counterpart of ``jax.random`` keys.

A batch of keys is a ``(B,)`` int64 tensor of per-lane seeds.  A draw is a
counter-based function of (lane key, lane iteration): the splitmix64 stream
of the key, ``mix(key + (it + 1) * GOLDEN)``, evaluated in int64 tensor ops
on the keys' device, with no host sync.  So a lane draws the same numbers
whatever batch it sits in and wherever it sits there, and a straggler
gathered by compaction keeps its own stream.  A shared ``torch.Generator``
drawing one ``(B,)`` tensor per iteration would not: a gathered lane would
draw another lane's numbers.

The values differ from JAX's threefry stream, which torch cannot reproduce;
parity tests feed JAX's uniforms through a solver's ``draw`` hook instead.

int64 arithmetic wraps modulo 2^64 on the CPU and on CUDA; right shifts are
arithmetic, so every shift is masked to make it logical.
"""
from __future__ import annotations

import math

import torch

__all__ = ["split_keys", "fold_in", "uniform", "check_keys"]


def _s64(c):
    """An unsigned 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)


def _shr(z, k):
    """Logical right shift of int64 ``z`` by ``k`` bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix(z):
    """splitmix64's finaliser on an int64 tensor."""
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def split_keys(seed, B, device=None):
    """``B`` per-lane keys from one integer seed: the counterpart of
    ``jax.random.split(PRNGKey(seed), B)``."""
    base = _mix(torch.tensor(int(seed), dtype=torch.int64, device=device) + _GOLDEN)
    i = torch.arange(1, B + 1, dtype=torch.int64, device=device)
    return _mix(base + i * _GOLDEN)


def fold_in(keys, d):
    """Each lane's key with the integer ``d`` folded in: a new stream per
    lane, independent of the old one (``jax.random.fold_in``)."""
    return _mix(keys ^ _mix(torch.full_like(keys, int(d)) + _GOLDEN))


def uniform(keys, it, dtype=torch.float64):
    """One draw in [0, 1) per lane: ``(B,)`` in ``dtype``, from each lane's
    key and its iteration ``it`` (an int tensor of shape ``(B,)``).  The top
    bits of the hash, as many as ``dtype``'s significand holds, scale
    exactly into ``dtype``, so no value rounds up to 1."""
    h = _mix(keys + (it.to(torch.int64) + 1) * _GOLDEN)
    bits = 1 - int(math.log2(torch.finfo(dtype).eps))
    return (_shr(h, 64 - bits).to(torch.float64) * 2.0 ** -bits).to(dtype)


def check_keys(keys, B, device):
    """Keys for a batch of ``B`` lanes on ``device``: a ``(B,)`` int64
    tensor there, or raise."""
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64:
        raise TypeError(f"keys must be an int64 tensor of per-lane seeds, got "
                        f"{getattr(keys, 'dtype', type(keys).__name__)}")
    if keys.shape != (B,):
        raise ValueError(f"keys must be ({B},), one per lane, got {tuple(keys.shape)}")
    if keys.device != torch.device(device):
        raise ValueError(f"keys are on {keys.device}, the batch on {device}")
    return keys
