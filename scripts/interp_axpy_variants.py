#!/usr/bin/env python3
"""Why ``csrc/interp_axpy.cu`` has the shape it has: the kernel timed beside
variants of it and ``torch.lerp``, on one card.  The question it answers:
does the rate of this bytes-bound kernel come from more loads in flight per
thread, or from the shape of the grid and the cache hints?

Builds a few variants of the interpolation kernel (f32 only, same
arithmetic: the two products and the sum rounded separately) with ``nvcc``
into the git-ignored build directory, checks each against the plain version
bit for bit, then times them with ``chip_smoke.time_ms`` (device time, L2
flushed) on the embedding of GPT-Base, [50304, 768] f32, alpha 0.25, in
``--rounds`` rounds that alternate the order.  Variants:

  capped_stride    one 16-byte chunk per thread per grid-stride step, grid
                   capped at 8 blocks per SM (132 SMs)
  deep4_wave_cs    4 chunks in flight per thread, streaming loads and stores
                   (ld/st.global.cs), grid of one whole wave (occupancy)
  deep4_uncapped   4 chunks per thread in a 1024-chunk block tile, one block
                   per tile
  one_cs_loads     the kernel's shape (one chunk per thread, one block per
                   256 chunks) with streaming loads

Prints the card's name and power limit and one JSON line of mean times in
ms.  Needs one CUDA card and nvcc:

    python3 scripts/interp_axpy_variants.py
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ float ax(float x, float z, float ca, float cb) {
  return __fadd_rn(__fmul_rn(ca, x), __fmul_rn(cb, z));
}
__device__ __forceinline__ float4 ax4(float4 x, float4 z, float ca, float cb) {
  return make_float4(ax(x.x, z.x, ca, cb), ax(x.y, z.y, ca, cb), ax(x.z, z.z, ca, cb),
                     ax(x.w, z.w, ca, cb));
}
__global__ void capped_stride(const float4* a, const float4* b, float4* o, int64_t nv,
                              float ca, float cb) {
  const int64_t s = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nv; i += s)
    o[i] = ax4(__ldg(a + i), __ldg(b + i), ca, cb);
}
__global__ void deep4_wave_cs(const float4* a, const float4* b, float4* o, int64_t nv,
                              float ca, float cb) {
  const int64_t s = (int64_t)gridDim.x * blockDim.x;
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (; i + 3 * s < nv; i += 4 * s) {
    float4 x[4], z[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __ldcs(a + i + u * s);
#pragma unroll
    for (int u = 0; u < 4; ++u) z[u] = __ldcs(b + i + u * s);
#pragma unroll
    for (int u = 0; u < 4; ++u) __stcs(o + i + u * s, ax4(x[u], z[u], ca, cb));
  }
  for (; i < nv; i += s) __stcs(o + i, ax4(__ldcs(a + i), __ldcs(b + i), ca, cb));
}
__global__ void deep4_uncapped(const float4* a, const float4* b, float4* o, int64_t nv,
                               float ca, float cb) {
  const int64_t base = blockIdx.x * 1024LL + threadIdx.x;
  float4 x[4], z[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) if (base + 256 * u < nv) x[u] = __ldg(a + base + 256 * u);
#pragma unroll
  for (int u = 0; u < 4; ++u) if (base + 256 * u < nv) z[u] = __ldg(b + base + 256 * u);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (base + 256 * u < nv) o[base + 256 * u] = ax4(x[u], z[u], ca, cb);
}
__global__ void one_cs_loads(const float4* a, const float4* b, float4* o, int64_t nv,
                             float ca, float cb) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < nv) o[i] = ax4(__ldcs(a + i), __ldcs(b + i), ca, cb);
}
extern "C" int run(int which, const void* a, const void* b, void* o, long long nv, float ca,
                   float cb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4 *A = (const float4*)a, *B = (const float4*)b;
  float4* O = (float4*)o;
  if (which == 0) {
    long long g = (nv + 255) / 256;
    capped_stride<<<(unsigned)(g < 132 * 8 ? g : 132 * 8), 256, 0, s>>>(A, B, O, nv, ca, cb);
  } else if (which == 1) {
    int dev, sms, per;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, deep4_wave_cs, 256, 0);
    long long g = (nv / 4 + 255) / 256, w = (long long)sms * per;
    deep4_wave_cs<<<(unsigned)(g < w ? g : w), 256, 0, s>>>(A, B, O, nv, ca, cb);
  } else if (which == 2) {
    deep4_uncapped<<<(unsigned)((nv + 1023) / 1024), 256, 0, s>>>(A, B, O, nv, ca, cb);
  } else {
    one_cs_loads<<<(unsigned)((nv + 255) / 256), 256, 0, s>>>(A, B, O, nv, ca, cb);
  }
  return (int)cudaGetLastError();
}
"""
VARIANTS = ("capped_stride", "deep4_wave_cs", "deep4_uncapped", "one_cs_loads")


def build_variants():
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "interp_axpy_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "variants.cu").write_text(SOURCE)
    subprocess.run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(out / "variants.so"), str(out / "variants.cu")], check=True)
    lib = ctypes.CDLL(str(out / "variants.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("interp_axpy_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import interp_axpy as ia

    dev = torch.device("cuda", 0)
    lib = build_variants()
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn((50304, 768), generator=gen, device=dev) for _ in range(2))
    out = torch.empty_like(a)
    want = ia.interp_axpy_torch(a, b, 0.25)

    def variant(i):
        def fn():
            err = lib.run(i, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // 4, 0.75,
                          0.25, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{VARIANTS[i]}: cudaError_t {err}")
        return fn

    fns = {"kernel": lambda: ia.interp_axpy_cuda(a, b, 0.25),
           "torch.lerp": lambda: torch.lerp(a, b, 0.25)}
    fns.update({name: variant(i) for i, name in enumerate(VARIANTS)})
    for name, fn in fns.items():
        if name in VARIANTS:
            out.zero_()
            fn()
            got = out
        else:
            got = fn()
        if name != "torch.lerp" and not torch.equal(got, want):
            raise RuntimeError(f"{name} differs from the plain version")
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(chip_smoke.time_ms(fns[name], dev, iters=30))
    bound_ms = 4 * 3 * a.numel() / chip_smoke.PEAK_BYTES * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"shape": [50304, 768], "dtype": "float32", "bound_ms": bound_ms,
                      "ms": {k: sum(v) / len(v) for k, v in times.items()},
                      "ms_by_round": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
