"""The import check: the benchmark runs the PyTorch port and nothing of the
JAX package beside it.

Module names are compared by their top-level name, the part before the
first dot, as whole words: the port's ``ccqppy_tpu_torch`` begins with
the JAX package's name and is allowed; ``ccqppy_tpu`` is not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ccqppy_tpu"})


def top_level(name):
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
