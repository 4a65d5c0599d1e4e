"""Run one cell of the benchmark:

    python3 simbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``simbench/``
and the program under ``src/``. The last line of standard output is the
result; the compared numbers and their limits are the last lines of
standard error.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.path[0] = str(root)     # not simbench/: its modules are a package
    from simbench.harness import main
    sys.exit(main(t0=T0))
