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
// What this design does about it: one elementwise pass with a grid-stride
// loop and 16-byte loads (4 f32 or 8 bf16 per thread per load) when the
// pointers are aligned, then a masked scalar tail.  The TPU version pads a
// copy of both inputs to whole 1024-element blocks; here the tail is masked
// and nothing is copied.  The products and the sum are rounded separately
// (__fmul_rn / __fadd_rn, no contraction into an FMA), the same rounding as
// the plain PyTorch version.

#include "common.cuh"

namespace reprotorch {
namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kElementwiseThreads)
interp_axpy_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                   int64_t n, float ca, float cb) {
  const int64_t n_vec = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t vi = tid; vi < n_vec; vi += stride) {
    alignas(16) T x[VEC];
    alignas(16) T z[VEC];
    alignas(16) T y[VEC];
    load_vec<T, VEC>(x, a + vi * VEC);
    load_vec<T, VEC>(z, b + vi * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      y[e] = from_f32<T>(__fadd_rn(__fmul_rn(ca, to_f32(x[e])), __fmul_rn(cb, to_f32(z[e]))));
    store_vec<T, VEC>(out + vi * VEC, y);
  }
  for (int64_t i = n_vec * VEC + tid; i < n; i += stride)  // masked tail
    out[i] = from_f32<T>(__fadd_rn(__fmul_rn(ca, to_f32(a[i])), __fmul_rn(cb, to_f32(b[i]))));
}

template <typename T>
cudaError_t launch_axpy(const void* a, const void* b, void* out, long long n, float ca,
                        float cb, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  if (aligned16(a) && aligned16(b) && aligned16(out)) {
    interp_axpy_kernel<T, V><<<elementwise_blocks(n / V + 1), kElementwiseThreads, 0,
                               stream>>>(pa, pb, po, n, ca, cb);
  } else {
    interp_axpy_kernel<T, 1><<<elementwise_blocks(n), kElementwiseThreads, 0, stream>>>(
        pa, pb, po, n, ca, cb);
  }
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
