"""The benchmark of ``repro_torch`` on one NVIDIA H100: ``run.py`` runs one
cell once (see ``BENCHMARK.json``)."""
