"""The benchmark of trgt_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. The
last line of standard output is the run's result as one JSON object;
the numbers the correctness check compared, each with its limit, are
the last lines of standard error. See gpubench/harness.py.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
