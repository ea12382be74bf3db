"""Random QP ensembles, per-lane RNG keys, guarded timing; ``utils.convert``
(import it by name: it needs the models) carries problems, sets and configs
over from the JAX package."""
from ccqppy_tpu_torch.utils import benchmark, random_qp, rng  # noqa: F401
from ccqppy_tpu_torch.utils.benchmark import (TimedRun, dense_sweep_bytes,  # noqa: F401
                                              materialize, timed_run)
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch  # noqa: F401
