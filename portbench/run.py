"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, configurations and metrics are those
of ``BENCHMARK.json``; the last line of standard output is the result as one
JSON object. See ``portbench/harness.py``.
"""
import time

T0 = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("USE_FLAX", "0")

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
