"""The benchmark of the PyTorch and CUDA port (`tpu_dra_torch`): one cell
a run, `python3 benchmark/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>`.  See `harness`."""
