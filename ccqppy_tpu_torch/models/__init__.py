"""Solvers: plain functions on batched tensors.

Each solver module exposes ``solve(A, b, x0=None, proj=None, config=...)``
for A (B, n, n), b (B, n), returning a ``SolveResult`` with a leading lane
axis.  ``SOLVERS`` maps short names to (solve_fn, config_cls).
"""
from ccqppy_tpu_torch.models import apgd, bbpgd, direct, mprgp, pcg, pgd, spg
from ccqppy_tpu_torch.models.apgd import APGDConfig, APGDSCConfig
from ccqppy_tpu_torch.models.base import SolveResult, SolverConfig, pg_residual
from ccqppy_tpu_torch.models.bbpgd import BBPGDConfig, BBPGDfConfig
from ccqppy_tpu_torch.models.direct import (direct_x0, solve_direct_batched,
                                            spd_inverse_batch)
from ccqppy_tpu_torch.models.mprgp import MPRGPBBConfig, MPRGPConfig
from ccqppy_tpu_torch.models.pcg import PCGConfig
from ccqppy_tpu_torch.models.pgd import PGDConfig
from ccqppy_tpu_torch.models.spg import SPGConfig

SOLVERS = {
    "pgd": (pgd.solve, PGDConfig),
    "apgd": (apgd.solve, APGDConfig),
    "apgd_ar": (apgd.solve_anti_relaxation, APGDConfig),
    "apgd_sc": (apgd.solve_sc, APGDSCConfig),
    "bbpgd": (bbpgd.solve, BBPGDConfig),
    "bbpgd_f": (bbpgd.solve_fallback, BBPGDfConfig),
    "spg": (spg.solve, SPGConfig),
    "mprgp": (mprgp.solve, MPRGPConfig),
    "mprgp_bb": (mprgp.solve_bb, MPRGPBBConfig),
    "pcg": (pcg.solve, PCGConfig),
}

__all__ = ["SOLVERS", "SolveResult", "SolverConfig", "pg_residual", "pgd",
           "apgd", "bbpgd", "spg", "mprgp", "pcg", "direct", "PGDConfig",
           "APGDConfig", "APGDSCConfig", "BBPGDConfig", "BBPGDfConfig", "SPGConfig",
           "MPRGPConfig", "MPRGPBBConfig", "PCGConfig", "direct_x0", "solve_direct_batched",
           "spd_inverse_batch"]
