"""One run of one cell of BENCHMARK.json on the CUDA device(s) of this machine:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the numbers the correctness check
compared, each beside its limit, as the last lines of standard error, and
the result as one JSON object on the last line of standard output. Exits
non-zero, printing no result, without the CUDA devices the cell asks for or
when a module of JAX or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from port_bench.harness.core import main

    sys.exit(main(T_START))
