"""Random QP ensembles, guarded timing, conversion from the JAX package."""
from ccqppy_tpu_torch.utils import benchmark, convert, random_qp  # noqa: F401
from ccqppy_tpu_torch.utils.benchmark import (TimedRun, dense_sweep_bytes,  # noqa: F401
                                              materialize, timed_run)
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch  # noqa: F401
