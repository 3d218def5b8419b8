"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of LAPS:
serving cells on one H100, driven from ``BENCHMARK.json`` (see
``run.py``)."""
