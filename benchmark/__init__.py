"""The benchmark of the PyTorch and CUDA prover (stark_anatomy_tpu_torch).

BENCHMARK.json at the repository's root names its configurations, cells and
metrics; run.py runs one cell once; harness.py finds every configuration,
traffic mix, metric reader and kernel attribution by the name it is given.
Nothing here imports JAX or the JAX package, and reference/ imports nothing
of the program either.
"""
