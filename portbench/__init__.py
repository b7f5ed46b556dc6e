"""The port's benchmark: exact NN-DTW search with ``repro_torch``, driven
as data (``BENCHMARK.json`` names the cells; each cell, configuration,
traffic mix and per-layer metric is a file of its own here)."""
