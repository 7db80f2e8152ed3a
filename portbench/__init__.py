"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one command,
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by the files beside this one (see README.md)."""
