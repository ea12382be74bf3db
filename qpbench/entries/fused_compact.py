"""Call path: ``solve_batched_fused_compact`` from the Jacobi start.

Set-up: the kernel library, the program's set and solver config.  A call:
``P(-b / diag A)``, then phase 1 of the mix's solver on its ``phase1``
budget, its first ``bucket`` stragglers re-solved on what is left
(``host_fallback`` as the mix says).  The iterative box mode and the cone
MPRGP-BB mode."""
from __future__ import annotations

from types import SimpleNamespace

from qpbench.entries import _port
from qpbench.entries._program import counters  # noqa: F401  (read by the harness)

from ccqppy_tpu_torch.parallel import batch

UNCOUNTED_SWEEPS = 0


def prepare(inputs, mix):
    _port.load_kernels(inputs.device)
    return SimpleNamespace(
        A=inputs.A, diag=inputs.A.diagonal(dim1=-2, dim2=-1),
        proj=_port.port_set(inputs.config, inputs.device),
        cfg=_port.solver_config(mix["solver"], inputs.config), mix=mix)


def call(s, b):
    m = s.mix
    return batch.solve_batched_fused_compact(
        m["solver"], s.A, b, int(m["phase1"]), x0=_port.jacobi_start(s.proj, s.diag, b),
        proj=s.proj, config=s.cfg, bucket=int(m["bucket"]), host_fallback=bool(m["host_fallback"]))
