"""Utilities: oracle problems (``problems``), random QP ensembles, per-lane
RNG keys (``rng``), guarded timing and the random-ensemble benchmark
harness (``benchmark``), plotting.  Import by name: ``diagnostics``
(timing, traces, profiling, result checks) and ``convert`` (problems, sets
and configs from the JAX package), which need the models."""
from ccqppy_tpu_torch.utils import benchmark, plotting, problems, random_qp, rng  # noqa: F401
from ccqppy_tpu_torch.utils.benchmark import (BenchmarkRandomCCQP,  # noqa: F401
                                              BenchmarkResult, TimedRun,
                                              default_families, dense_sweep_bytes,
                                              disjoint_families, materialize,
                                              timed_run)
from ccqppy_tpu_torch.utils.random_qp import random_qp_batch  # noqa: F401

__all__ = ["problems", "random_qp", "random_qp_batch", "BenchmarkRandomCCQP",
           "BenchmarkResult", "default_families", "disjoint_families",
           "benchmark", "plotting", "timed_run", "TimedRun", "materialize",
           "dense_sweep_bytes"]
