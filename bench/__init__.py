"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``).

``run.py`` is the command that ``BENCHMARK.json`` names. Everything that
belongs to one configuration, traffic mix, per-layer metric or cell
lives in a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it (``manifest.py``).
"""
