"""The launch floor: the device time of an empty kernel, launched as the
port launches its kernels.

    python -m hyperspace_torch.benchmarks.launch_floor

needs one CUDA device and ``nvcc``; it prints one JSON line with the
device ms of an empty kernel (one block of 32 threads) launched from a C
launcher loaded with ``ctypes`` on PyTorch's current stream, over 20
calls (``benchmarks/devtime.py``): the least a launch of any kernel here
costs on the card's clock.  ``chip_smoke.py`` prints it as ``floor_ms``.
The kernel is built at first use into ``build/launch_floor`` at the root
of the checkout, never by the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess

import torch

from hyperspace_torch.benchmarks.devtime import profile_window
from hyperspace_torch.kernels import _support as S

OUT = os.path.join(os.path.dirname(S.BUILD_DIR), "launch_floor")
FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void probe_empty_kernel() {}
extern "C" int hs_probe_floor(void* stream) {
  probe_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def floor_ms(reps: int = 20):
    """Device ms a launch of the empty kernel, or None where the profiler
    recorded nothing."""
    os.makedirs(OUT, exist_ok=True)
    tag = hashlib.sha256(FLOOR_SRC.encode()).hexdigest()[:16]
    so = os.path.join(OUT, f"floor-{tag}.so")
    if not os.path.exists(so):
        src = os.path.join(OUT, f"floor-{tag}.cu")
        with open(src, "w") as f:
            f.write(FLOOR_SRC)
        subprocess.run([S._nvcc(), *S.NVCC_FLAGS, "-o", so + ".tmp", src],
                       check=True, capture_output=True)
        os.replace(so + ".tmp", so)
    fn = ctypes.CDLL(so).hs_probe_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    items = profile_window(
        torch, lambda: S.check(fn(stream), "probe_floor"), reps)[0]
    return sum(items.values()) if items else None


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_floor: CUDA is not available")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"floor_ms": floor_ms(), "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
