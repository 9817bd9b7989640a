"""What bounds the flash-attention backward kernels on the card.

    python -m hyperspace_torch.benchmarks.flash_probe

needs one CUDA device and ``nvcc``; it prints JSON lines:

- ``registers``: each flash kernel's registers and spill bytes at every
  width DP, from ``nvcc -Xptxas -v`` on ``kernels/csrc/attention.cu``,
  and for dq and dk/dv at DP 40 and 72 the local-memory instructions
  (``LDL``/``STL``) inside the span of their tensor-core loop, read from
  ``cuobjdump -sass`` of the same build;
- ``occupancy``: blocks of dq and dk/dv resident on one SM at D = 33
  and 72 (``hs_flash_bwd_blocks_per_sm``);
- ``mma_rate``: the card's rate for ``mma.sync.m16n8k8`` TF32 with 8
  independent accumulators a warp and with one, at 4 to 32 warps an SM
  (TFLOP/s and MMAs per SM per µs; the rate of a single chain gives the
  instruction's latency);
- ``widths``: dq and dk/dv device ms at the HyboNet bench leg's sequence
  shape ([1024, 128, D], sequences of 64..128 tokens) for D = 33 and 72,
  with the MMAs each launch issues, so the two widths compare per MMA.

Builds go to ``build/flash_probe`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from hyperspace_torch.benchmarks.devtime import profile_window, ptxas_usage
from hyperspace_torch.kernels import _support as S
from hyperspace_torch.kernels import attention as A

OUT = os.path.join(os.path.dirname(S.BUILD_DIR), "flash_probe")

MMA_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}
template <int CH>
__global__ void chains(int iters, float* out) {
  const unsigned a[4] = {threadIdx.x, 1u, 2u, 3u};
  float c[CH][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) mma(c[j], a, i, j);
  float s = 0.0f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int chains_a_warp, int blocks, int iters, float* out,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chains_a_warp == 8) chains<8><<<blocks, 128, 0, s>>>(iters, out);
  else chains<1><<<blocks, 128, 0, s>>>(iters, out);
  return (int)cudaGetLastError();
}
"""


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def registers() -> None:
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "attention_v.so")

    def name_of(sym):
        k = re.search(r"flash_(fwd|dq|dkv)_kernelILi(\d+)E", sym)
        return f"{k.group(1)}{k.group(2)}" if k else None

    regs = ptxas_usage(S._nvcc(), S.NVCC_FLAGS,
                       os.path.join(S.CSRC, "attention.cu"), so, name_of)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(S._nvcc()), "cuobjdump"), "-sass", so],
        capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        k = re.search(r"flash_(dq|dkv)_kernelILi(40|72)E", f.split("\n")[0])
        if not k:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\S*)",
                         f)
        mma = [i for i, op in enumerate(ops) if op.startswith("HMMA")]
        local = [i for i, op in enumerate(ops)
                 if op.split(".")[0] in ("LDL", "STL")]
        regs[f"{k.group(1)}{k.group(2)}"].update(
            instructions=len(ops), hmma=len(mma),
            local_in_loop=sum(mma[0] <= i <= mma[-1] for i in local))
    emit({"probe": "registers", "by_kernel_dp": regs})


def mma_rate() -> None:
    src = os.path.join(OUT, "mma_rate.cu")
    so = os.path.join(OUT, "mma_rate.so")
    with open(src, "w") as f:
        f.write(MMA_SRC)
    subprocess.run([S._nvcc(), *S.NVCC_FLAGS, "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 32 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for chains in (8, 1):
        for warps in (4, 8, 16, 32):
            blocks = sms * warps // 4
            S.check(lib.run(chains, blocks, 16, out.data_ptr(), stream),
                    "mma_rate")
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            S.check(lib.run(chains, blocks, iters, out.data_ptr(), stream),
                    "mma_rate")
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
            mmas = blocks * 4 * iters * chains
            emit({"probe": "mma_rate", "chains_a_warp": chains,
                  "warps_an_sm": warps, "ms": ms,
                  "tflops": mmas * 2048 / ms / 1e9,
                  "mma_per_sm_per_us": mmas / sms / (ms * 1e3)})


def device_ms(fn, reps: int = 20) -> float:
    return sum(profile_window(torch, fn, reps)[0].values())


def widths() -> None:
    dev = torch.device("cuda")
    for d in (33, 72):
        rng = np.random.default_rng(5)
        b, heads, n = 1024, 4, 128

        def rows():
            sp = rng.standard_normal((b, n, d - 1)) * 0.5
            t = np.sqrt(1.0 + np.sum(sp * sp, axis=-1, keepdims=True))
            return torch.as_tensor(np.concatenate([t, sp], axis=-1),
                                   dtype=torch.float32, device=dev)

        q, k, v = rows(), rows(), rows()
        lens = rng.integers(64, n + 1, b // heads)
        m = np.arange(n)[None, :] < lens[:, None]
        mask = torch.as_tensor((m[:, None, :] & m[:, :, None]).astype(
            np.uint8), device=dev)
        beta = torch.zeros(b, device=dev)
        tau = torch.ones(b, device=dev)
        out, lse, _ = A.flash_fwd(q, k, v, 1.0, beta, tau, mask, heads)
        dsp = torch.randn_like(out)
        di = torch.sum(dsp * out, dim=-1)
        args = (q, k, v, 1.0, beta, tau, mask, heads, dsp, lse, di)
        kd = -(-d // 8)
        # warp-tiles (16 rows × 64) the launches run, skipped halves aside
        tiles = b * (n // 16) * (n // 64)
        emit({"probe": "widths", "d": d, "dp": 8 * kd,
              "dq_ms": device_ms(lambda: A.flash_dq(*args)),
              "dkv_ms": device_ms(lambda: A.flash_dkv(*args)),
              "dq_mma": tiles * 8 * 9 * kd, "dkv_mma": tiles * 8 * 12 * kd,
              "blocks_per_sm": [A._blocks_per_sm(0, w, d) for w in (0, 1)]})


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe needs a CUDA device")
    emit({"probe": "card", "name": torch.cuda.get_device_name(0)})
    registers()
    emit({"probe": "occupancy",
          "blocks_per_sm": {f"{k}_d{d}": A._blocks_per_sm(0, w, d)
                            for d in (33, 72)
                            for w, k in ((0, "dq"), (1, "dkv"))}})
    mma_rate()
    widths()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
