"""The benchmark of ``genomad_torch``, the PyTorch and CUDA port of geNomad.

``python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See
``benchmark/README.md``.
"""
