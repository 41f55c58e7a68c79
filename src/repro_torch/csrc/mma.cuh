// Tensor-core building blocks for the bf16 attention bodies, in inline PTX:
// mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix, cp.async with zero
// fill, an XOR-swizzled shared-memory tile layout, a one-instruction exp2,
// and the packing of an f32 accumulator fragment into a bf16 A-operand
// fragment.  Free of CUTLASS and
// PyTorch headers, so each source that includes it builds in seconds.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// lane = 4 g + c (g = lane / 4, c = lane % 4):
//   A, 16 x 16 row-major: a[0] (row g, cols 2c, 2c+1), a[1] (row g+8, same),
//                         a[2] (row g, cols 2c+8, 2c+9), a[3] (row g+8, same);
//   B, 16 x 8 (k x n):    b[0] (k 2c, 2c+1; col g), b[1] (k 2c+8, 2c+9; col g);
//   C, 16 x 8 f32:        c[0..1] (row g, cols 2c, 2c+1), c[2..3] (row g+8).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace reprotorch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b, one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and r[i] receives this lane's pair of it (row lane / 4, cols 2 (lane % 4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: r[i] holds (rows 2 (lane % 4), +1; col lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, bypassing L1; `valid` false writes 16 zero bytes
// and reads nothing (src-size 0), for rows past the end.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (zero when `valid` is false).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element offset of (row, 16-byte chunk) in a [rows x D] bf16 tile whose
// chunks are XOR-swizzled by row % 8: the 8 rows one ldmatrix phase reads at
// one column fall in 8 different bank groups, so neither ldmatrix nor the
// 16-byte cp.async writes conflict.  D / 8 chunks per row, D a multiple of 64
// (the XOR stays inside each aligned group of 8 chunks).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction (max relative error 2^-22; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 -> one register of two bf16 (lo in the low half), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of n-tiles 2j and 2j+1 (a 16 x 16 block of an f32
// accumulator) as the bf16 A fragment of k-step j.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy ROWS rows of D bf16 (row i at src + i * stride elements, rows at or
// past `limit` zero-filled) into a swizzled tile, by all NTHREADS threads.
// Where the row's D / 8 chunks divide NTHREADS, each thread copies the same
// 16-byte column of every (NTHREADS / (D / 8))-th row, a fixed number of
// times, so the addresses are computed once.  Rows of D = 192 (24 chunks)
// do not divide 128 threads: the tile's chunks are then walked flat, each
// thread computing its row and column per chunk.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int64_t stride, int limit) {
  constexpr int CH = D / 8;                  // 16-byte chunks per row
  if constexpr (NTHREADS % CH == 0) {
    constexpr int RSTEP = NTHREADS / CH;     // rows between one thread's chunks
    constexpr int PER = ROWS / RSTEP;        // chunks per thread
    static_assert(ROWS % RSTEP == 0 && RSTEP % 8 == 0, "tile does not divide");
    const int ch = threadIdx.x % CH, r0 = threadIdx.x / CH;
    const uint32_t base = smem_addr(dst) + 2 * swz<D>(r0, ch);  // r & 7 == r0 & 7 for all r
    const __nv_bfloat16* g = src + r0 * stride + ch * 8;
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const bool ok = r0 + it * RSTEP < limit;
      cp_async16(base + 2 * it * RSTEP * D, ok ? g + it * RSTEP * stride : src, ok);
    }
  } else {
    static_assert((ROWS * CH) % NTHREADS == 0, "tile does not divide");
#pragma unroll
    for (int it = 0; it < ROWS * CH / NTHREADS; ++it) {
      const int i = threadIdx.x + it * NTHREADS;
      const int r = i / CH, ch = i % CH;
      const bool ok = r < limit;
      cp_async16(smem_addr(dst + swz<D>(r, ch)), ok ? src + r * stride + ch * 8 : src, ok);
    }
  }
}

}  // namespace reprotorch
