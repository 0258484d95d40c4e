"""Run one cell of the port's benchmark once and print its result line.

    python3 -m fusionbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits non-zero, and prints no result,
without as many CUDA devices as the cell asks for, or when the process
has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402


def main() -> int:
    from fusionbench.harness import main as harness_main

    return harness_main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
