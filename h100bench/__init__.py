"""h100bench: the benchmark of the PyTorch and CUDA port (``biscuit_torch``)
on one NVIDIA H100. ``python3 h100bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.
"""
