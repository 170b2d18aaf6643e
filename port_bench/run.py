"""The benchmark's command:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (the result) last on stdout; fails, printing no
result, without enough CUDA devices for the cell, or where the port or
JAX is found where it must not be."""

import time

T_PROC = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

# the repository root in place of this directory: the port and this
# package are imported from it, and no module here shadows a library's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    from port_bench import bench

    sys.exit(bench.main(t_proc=T_PROC))
