"""Run one cell of the port's benchmark once, on the CUDA device(s) here.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Prints one JSON line as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit) and the checks again as the last
lines of standard error. Exits non-zero, printing no line, without enough
CUDA devices, or if the run loaded JAX or the JAX package. Whatever else
writes to standard output while the run goes goes to standard error.
"""

import os
import sys
import time

_PERF0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout; no library
# the port uses may load JAX on its own.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".portbench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, ".portbench_cache", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main() -> int:
    sys.path.insert(0, ROOT)
    from portbench import harness

    age = harness.process_age_s()
    started = time.perf_counter() - age if age is not None else _PERF0
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # library and program output goes to standard error
    sys.stdout = sys.stderr
    return harness.main(sys.argv[1:], started, out)


if __name__ == "__main__":
    sys.exit(main())
