"""The benchmark of ``tempest_tpu_torch``, the PyTorch and CUDA port, on an
NVIDIA H100: ``python3 -m portbench --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  See ``README.md`` beside this file."""
