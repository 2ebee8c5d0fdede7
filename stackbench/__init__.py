"""The benchmark of the PyTorch / CUDA port (``libstacker_tpu_torch``):
``python3 stackbench/run.py --workload NAME --seed N --seconds S --trace
0|1``.  See ``stackbench/README.md``."""
