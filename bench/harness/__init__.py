"""The benchmark harness of the PyTorch / CUDA port: one cell of
``BENCHMARK.json`` run once (``bench/run.py``)."""
