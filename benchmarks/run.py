"""One run of one cell of the benchmark (BENCHMARK.json at the checkout's
root):

    python3 benchmarks/run.py --workload bunny.pt --seed 7 --seconds 45 \
        --trace 0

The last line of standard output is the result, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `check`, each compared number with its limit; the
same numbers are the last lines of standard error. Without a CUDA device,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, the run prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    try:
        result = harness.run(args, T_START)
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    if result is None:  # a rank other than 0
        return 0
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
