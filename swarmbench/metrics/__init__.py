"""One module a per-layer metric, named as in ``BENCHMARK.json``."""
