"""The benchmark of the PyTorch/CUDA port (``vae_hmc_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  The yardstick
lives here: the corpus and weight generators, the counters of operations
and bytes, the trace reading, the plain reference (``reference/``) and
the comparisons that decide ``correct``.  Nothing here imports JAX or the
JAX package, and ``reference/`` imports nothing of the port.
"""
