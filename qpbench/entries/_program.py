"""The program's own telemetry as the benchmark reads it: its counters and
its gated span.  Beside the entries, the only module of the benchmark that
imports the program.  A counter or span the program does not have (an
older commit) is left out."""
from __future__ import annotations

from ccqppy_tpu_torch.models import apgd, base
from ccqppy_tpu_torch.ops import gemv

#: Counter name -> (module of the program, the attribute that holds it).
COUNTERS = {"gemv_launches": (gemv, "LAUNCHES"), "gemv_lanes_swept": (gemv, "LANES_SWEPT"),
            "host_syncs": (base, "HOST_SYNCS"), "sc_steps_fused": (apgd, "SC_STEPS_FUSED"),
            "sc_steps_eager": (apgd, "SC_STEPS_EAGER")}

#: ``models.base.span`` (a ``record_function`` only while a profiler
#: records), or None.
span = getattr(base, "span", None)


def counters():
    """The program's counters as they stand: GEMV kernel launches, the lanes
    of A those launches streamed, host reads of a device value, and
    ``apgd_sc`` iterations on the fused step kernel and on the eager body."""
    return {name: int(getattr(mod, attr)) for name, (mod, attr) in COUNTERS.items()
            if hasattr(mod, attr)}
