"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
a call, ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; see ``harness`` for how a cell's files
are found."""
