"""What the entries share: the program's constraint set, solver config and
start point built from a configuration and a mix.  With the entries, the
only module of the benchmark that imports the program."""
from __future__ import annotations

import torch

from ccqppy_tpu_torch.models import SOLVERS
from ccqppy_tpu_torch.ops import kernels
from ccqppy_tpu_torch.ops.projections import blockwise, box, lorentz_cone


def load_kernels(device):
    """Build (first run in a checkout) and load the kernel library."""
    if device.type == "cuda":
        kernels.load()


def port_set(config, device):
    """The program's projection for the configuration's set."""
    s, n = config["set"], int(config["n"])
    dtype = torch.float32 if config["dtype"] == "float32" else torch.float64
    if s["kind"] == "box":
        return box(torch.full((n,), float(s["lower"])), torch.full((n,), float(s["upper"])),
                   dtype=dtype, device=device)
    if s["kind"] == "lorentz_blocks":
        return blockwise(lorentz_cone(float(s["mu"]), dtype=dtype, device=device),
                         int(s["block_dim"]))
    raise ValueError(f"unknown set {s['kind']!r}")


def solver_config(solver, config):
    """The solver's config at the configuration's tol and budget."""
    return SOLVERS[solver][1](tol=float(config["tol"]), max_matvecs=int(config["budget"]),
                              gd=float(config["gd"]))


def jacobi_start(proj, diag, b):
    """The (cone-)Jacobi start ``P(-b / diag A)``."""
    return proj.project(-b / diag)
