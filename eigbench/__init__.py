"""The benchmark of eigenex_tpu_torch: ``python3 eigbench/run.py --workload <name>``."""
