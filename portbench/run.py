"""Entry point of the port's benchmark; see ``portbench/harness.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys
import time

STARTED = time.perf_counter()  # set-up is counted from here, imports included
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every cache the run may fill lives at a fixed path inside the checkout;
# the port's own kernels build into build/torch_kernels/ there.
for variable, folder in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                         ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[variable] = os.path.join(ROOT, "build", "portbench", folder)
os.environ["USE_FLAX"] = "0"  # transformers, where anything loads it, stays off JAX
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
