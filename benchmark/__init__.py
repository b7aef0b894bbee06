"""The benchmark of ``flyp_tpu_torch`` on NVIDIA GPUs: ``run.py`` runs one
cell of ``BENCHMARK.json`` once and prints its result line."""
