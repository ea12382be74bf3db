"""qpbench: the benchmark of ccqppy_tpu_torch, the PyTorch and CUDA port.

``python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on one card and prints its result
line.  See ``harness`` for a run, ``registry`` for how a cell's files are
found, ``check`` for how ``correct`` is decided.
"""
