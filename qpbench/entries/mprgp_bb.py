"""Call path: fused MPRGP-BB on the plain ``DenseOperator``, uncompacted.

Set-up: the kernel library and the operator; nothing is estimated.  A
call: ``solve_batched("mprgp_bb")`` (the fused form, expansion "bb",
gamma 1) from the cone-Jacobi start ``P(-b / diag A)``.  Besides the
counters of ``_program``, the entry reads the MPRGP loop's own (its
iterations and its f64 audit sweeps) and the launches of the GEMV's (f32
A, f64 x) instance; a program without them leaves them out."""
from __future__ import annotations

from types import SimpleNamespace

from qpbench.entries import _port, _program

from ccqppy_tpu_torch.models import mprgp
from ccqppy_tpu_torch.ops import gemv
from ccqppy_tpu_torch.ops.linop import DenseOperator
from ccqppy_tpu_torch.parallel import batch

UNCOUNTED_SWEEPS = 0

#: Counter name -> (module of the program, the attribute that holds it).
COUNTERS = {"mprgp_iters": (mprgp, "MPRGP_ITERS"), "mprgp_audits": (mprgp, "MPRGP_AUDITS"),
            "gemv_launches_f32_f64": (gemv, "LAUNCHES_F32_F64")}


def counters():
    """``_program.counters()``, the MPRGP loop's passes and f64 audit sweeps,
    and the launches of the GEMV's (f32 A, f64 x) instance."""
    out = _program.counters()
    for name, (mod, attr) in COUNTERS.items():
        value = getattr(mod, attr, None)
        if value is not None:
            out[name] = int(value)
    return out


def prepare(inputs, mix):
    _port.load_kernels(inputs.device)
    return SimpleNamespace(
        op=DenseOperator(inputs.A), diag=inputs.A.diagonal(dim1=-2, dim2=-1),
        proj=_port.port_set(inputs.config, inputs.device),
        cfg=_port.solver_config("mprgp_bb", inputs.config))


def call(s, b):
    return batch.solve_batched("mprgp_bb", s.op, b, x0=_port.jacobi_start(s.proj, s.diag, b),
                               proj=s.proj, config=s.cfg)
