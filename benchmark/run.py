"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (one JSON object); the checks of ``correct`` are the last lines of
standard error.
"""

import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
