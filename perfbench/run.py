"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `perfbench/` and
the port (`spnet_tpu_torch/`).  The run loads and warms up (`setup_s`),
measures for `--seconds`, checks what the measured path produced against
the plain reference in `perfbench/reference/`, and prints one JSON object
as the last line of its standard output; with `--trace 1` it reads the
per-layer metrics from a traced tail after the measured window.  It exits
with another code than 0 and prints no result without a CUDA card, or if
JAX or the JAX package was loaded.  `perfbench/README.md` says more.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache"
# every compiler cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
# the checkout's root, not this directory, is where imports start
sys.path[0] = str(ROOT)

from perfbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t0=T0))
