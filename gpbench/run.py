"""Run one benchmark cell once:

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the compared numbers and their limits are the last lines of
standard error.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gpbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
