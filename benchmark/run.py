"""``python -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1``:
one run of one cell of BENCHMARK.json (``harness.py``)."""

import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
