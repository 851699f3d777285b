"""The benchmark of ``bmfr_tpu_torch``: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root
of a checkout, on a machine with a CUDA card (``BENCHMARK.json`` names
the cells). Nothing here imports JAX or the JAX package."""
