"""Runs one cell of the benchmark of ``kaolin_tpu_torch`` once and prints
its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

See ``portbench/harness.py``."""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T_START))
