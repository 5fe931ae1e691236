"""Run one cell of the port's benchmark once; the last line on standard
output is its result.  From the root of a checkout:

    python3 benchmark/run.py --workload all_1728.tick_nap --seed 7 --seconds 10 --trace 0
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache the run may write sits at a fixed path in
# the checkout (the port's own kernels build into build/torch_kernels)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness import cli  # noqa: E402

if __name__ == "__main__":
    # the process's start on the host clock, which set-up runs from
    started = time.perf_counter() - cli.process_age_s()
    sys.exit(cli.main(sys.argv[1:], started, ROOT))
