"""The port's benchmark entry and studies: ``ccqppy_tpu_torch.bench`` (the
headline line) and the single-card studies of the JAX package's
``benchmarks/``, one module each, run as
``python -m ccqppy_tpu_torch.benchmarks.<module> [--device cuda|cpu]``.

Each study writes its JSON to ``build/bench_results/`` (``--out`` elsewhere)
with the JAX script's keys and a card stamp beside them.  The JAX package's
``benchmarks/results/`` holds the JAX runs and is never written here.
Nothing is run when a module is imported."""
