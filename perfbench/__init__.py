"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the repository root
names the cells, metrics and bounds; see ``perfbench/run.py``."""
