"""The benchmark of the PyTorch/CUDA port on an NVIDIA H100.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells; every
configuration, traffic mix, driver and per-layer metric is a file of its
own here, found by name (``common.py``).  The plain reference that
decides ``correct`` is ``reference/``: it imports nothing of the port.
"""
