"""Run one cell of the port's benchmark.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: puts the checkout's ``src`` and root on the
path, keeps every build and kernel cache inside the checkout, then hands
over to ``rtbench.harness``. Prints one JSON line last on standard
output; exits non-zero, printing no result, without the CUDA devices the
cell asks for.
"""
import time

T_PROCESS0 = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_start() -> float:
    """The process's start on the wall clock: now less its age from
    /proc (Linux, 10 ms ticks), else the time this module began."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        t = time.time() - (uptime - started)
        return t if 0 <= T_PROCESS0 - t < 60 else T_PROCESS0
    except (OSError, ValueError, IndexError):
        return T_PROCESS0


ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "rtbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from rtbench import harness

    sys.exit(harness.main(sys.argv[1:], process_start()))
