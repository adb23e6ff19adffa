"""The benchmark of ``cyclegan_tpu_torch`` (the PyTorch / CUDA port) on one H100.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. What a
cell is, and how to add one, is in ``portbench/README.md``. Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the port.
"""
