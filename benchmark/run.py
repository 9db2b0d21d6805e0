"""One run of one benchmark cell of the PyTorch and CUDA port on the GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the cell's metrics as one JSON
line last on standard output (see ``harness/core.py``).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout, so that only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")

if __name__ == "__main__":
    from benchmark.harness.core import main

    sys.exit(main(t_start=T_START))
