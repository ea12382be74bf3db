"""Call path: direct serving, the inverse resident.

Set-up: the kernel library, then ``spd_inverse_batch`` (batched Cholesky,
A^-1 of every lane).  A call: ``direct_x0`` (one sweep of A^-1, projected),
then fused-compacted PCG on the mix's ``phase1`` and ``bucket``.  The
inverse's sweep is not in the reported matvecs: ``UNCOUNTED_SWEEPS``."""
from __future__ import annotations

from types import SimpleNamespace

from qpbench.entries import _port
from qpbench.entries._program import counters  # noqa: F401  (read by the harness)

from ccqppy_tpu_torch.models.direct import direct_x0, spd_inverse_batch
from ccqppy_tpu_torch.parallel import batch

#: Sweeps a lane a call that its matvec count leaves out: the inverse's.
UNCOUNTED_SWEEPS = 1


def prepare(inputs, mix):
    _port.load_kernels(inputs.device)
    return SimpleNamespace(
        A=inputs.A, Ainv=spd_inverse_batch(inputs.A),
        proj=_port.port_set(inputs.config, inputs.device),
        cfg=_port.solver_config(mix["solver"], inputs.config), mix=mix)


def call(s, b):
    m = s.mix
    return batch.solve_batched_fused_compact(
        m["solver"], s.A, b, int(m["phase1"]), x0=direct_x0(s.Ainv, b, s.proj), proj=s.proj,
        config=s.cfg, bucket=int(m["bucket"]), host_fallback=bool(m["host_fallback"]))
