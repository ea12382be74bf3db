"""Call path: strong-convexity APGD on ``SpectralDense``, uncompacted.

Set-up: the kernel library, then ``estimate_spectral_bounds`` (2 x
(spectral_iters + 1) sweeps of the ensemble) into a ``SpectralDense``.  A
call: ``solve_batched("apgd_sc")`` from the cone-Jacobi start
``P(-b / diag A)``."""
from __future__ import annotations

from types import SimpleNamespace

from qpbench.entries import _port
from qpbench.entries._program import counters  # noqa: F401  (read by the harness)

from ccqppy_tpu_torch.ops.linop import SpectralDense, estimate_spectral_bounds
from ccqppy_tpu_torch.parallel import batch

UNCOUNTED_SWEEPS = 0


def prepare(inputs, mix):
    _port.load_kernels(inputs.device)
    L, mu = estimate_spectral_bounds(inputs.A, iters=int(mix["spectral_iters"]))
    return SimpleNamespace(
        op=SpectralDense(inputs.A, L, mu), diag=inputs.A.diagonal(dim1=-2, dim2=-1),
        proj=_port.port_set(inputs.config, inputs.device),
        cfg=_port.solver_config("apgd_sc", inputs.config))


def call(s, b):
    return batch.solve_batched("apgd_sc", s.op, b, x0=_port.jacobi_start(s.proj, s.diag, b),
                               proj=s.proj, config=s.cfg)
