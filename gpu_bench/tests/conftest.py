"""The benchmark's own CPU tests: ``python -m pytest gpu_bench/tests`` from the
root of the repo. The harness's modules sit in ``gpu_bench/`` and the
program at the root."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)
