"""The benchmark of render_engine_tpu_torch on one NVIDIA H100.

``run.py`` is the command; ``BENCHMARK.json`` at the repository root names
the cells, and each configuration, traffic mix and per-layer metric is a
file of its own under this directory (see README.md)."""
