"""The benchmark of ``repro_torch`` on one NVIDIA H100: ``bench/run.py``
runs one cell of ``BENCHMARK.json``; ``bench/README.md`` says how to add a
configuration, a traffic mix or a per-layer metric."""
