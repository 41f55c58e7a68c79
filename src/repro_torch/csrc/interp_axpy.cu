// Interpolation of two parameter tensors for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_axpy_kernel`, launched by `interp_axpy`
// in src/repro/kernels/interp_axpy.py.  Same function, the paper's Eq. 13:
// out = (1 - alpha) * a + alpha * b in f32, with the output in a's type.
//
// What bounds it on this card: bytes.  Two reads and one write per element
// against three flops, far below the H100's ~295 FLOP/byte ridge, so the
// floor is the 3.35 TB/s of HBM.
//
// What this design does about it: one 16-byte chunk of each input per
// thread (4 f32 or 8 bf16, a warp's loads on neighbouring addresses) and a
// grid that covers the tensor once, one block per 256 chunks, with no
// grid-stride loop: the block scheduler hands out blocks in address order
// as SMs free up, so the card streams through memory front to back with
// every SM busy until the last blocks.  What sets the rate on this card is
// the grid and the cache hints, not the loads in flight per thread
// (scripts/interp_axpy_variants.py times the alternatives beside this
// kernel and torch.lerp): a grid capped at 8 blocks per SM with a
// grid-stride loop is slower, and slower still with four chunks in flight
// per thread and streaming loads and stores over a one-wave grid;
// streaming loads (ld.global.cs) alone cost time; four chunks per thread
// over an uncapped grid gain nothing.  Misaligned pointers and the last
// n % 8 (bf16) or n % 4 (f32) elements take one element per thread,
// masked.  The TPU version pads a copy of both inputs to whole
// 1024-element blocks; here nothing is copied.  The products and the sum
// are rounded separately (__fmul_rn / __fadd_rn, no contraction into an
// FMA), the same rounding as the plain PyTorch version.

#include <algorithm>

#include "common.cuh"

namespace reprotorch {
namespace {

__device__ __forceinline__ float axpy(float x, float z, float ca, float cb) {
  return __fadd_rn(__fmul_rn(ca, x), __fmul_rn(cb, z));
}

// One 32-bit word of each input: one f32, or two bf16 (lo at the lower
// address; a bf16 is the top half of the f32 it widens to).
template <typename T>
__device__ __forceinline__ uint32_t axpy_word(uint32_t x, uint32_t z, float ca, float cb) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(axpy(__uint_as_float(x), __uint_as_float(z), ca, cb));
  } else {
    const float lo = axpy(__uint_as_float(x << 16), __uint_as_float(z << 16), ca, cb);
    const float hi = axpy(__uint_as_float(x & 0xffff0000u), __uint_as_float(z & 0xffff0000u),
                          ca, cb);
    __nv_bfloat162 y = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&y);
  }
}

// Thread i computes 16-byte chunk i when i < n_vec (n_vec is 0 when a
// pointer is misaligned), then element n_vec * vec16<T>() + i when that is
// below n.
template <typename T>
__global__ void __launch_bounds__(kElementwiseThreads)
interp_axpy_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                   int64_t n, int64_t n_vec, float ca, float cb) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_vec) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a) + i);
    const uint4 z = __ldg(reinterpret_cast<const uint4*>(b) + i);
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(axpy_word<T>(x.x, z.x, ca, cb), axpy_word<T>(x.y, z.y, ca, cb),
                   axpy_word<T>(x.z, z.z, ca, cb), axpy_word<T>(x.w, z.w, ca, cb));
  }
  const int64_t e = n_vec * vec16<T>() + i;  // masked scalar tail
  if (e < n) out[e] = from_f32<T>(axpy(to_f32(a[e]), to_f32(b[e]), ca, cb));
}

template <typename T>
cudaError_t launch_axpy(const void* a, const void* b, void* out, long long n, float ca,
                        float cb, cudaStream_t stream) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out);
  const long long n_vec = vec ? n / vec16<T>() : 0;
  const long long threads = std::max(n_vec, n - n_vec * vec16<T>());
  const long long blocks = (threads + kElementwiseThreads - 1) / kElementwiseThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  interp_axpy_kernel<T><<<static_cast<unsigned>(blocks), kElementwiseThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n, n_vec, ca,
      cb);
  return cudaGetLastError();
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// a, b, out: n contiguous elements of one storage type; ca = 1 - alpha,
// cb = alpha.  Returns the cudaError_t of the launch.
extern "C" int interp_axpy(const void* a, const void* b, void* out, int dtype,
                           long long n, float ca, float cb, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_axpy<float>(a, b, out, n, ca, cb, s);
  if (dtype == kBFloat16) return launch_axpy<__nv_bfloat16>(a, b, out, n, ca, cb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
