"""Benchmark of the PyTorch/CUDA port's P2P-SL round (``python
swarmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1``)."""
