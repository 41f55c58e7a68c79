// Width coalescing of one axis of a 2D weight for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pair_kernel`, launched by `coalesce_pair`
// in src/repro/kernels/coalesce_pair.py.  Same function: for the paper's
// "stack" averaging F, Y = w0 * (W[i] + W[i + n/2]) along axis 0 or 1, in
// f32, with the output in the input type.
//
// What bounds it on this card: bytes.  It reads each input element once and
// writes half as many; one add and one multiply per output is far below the
// H100's ~295 FLOP/byte ridge, so the floor is the 3.35 TB/s of HBM.
//
// What this design does about it: one elementwise pass with a grid-stride
// loop, each thread moving 16 bytes per load (4 f32 or 8 bf16) when the row
// width and both halves' offsets allow it, and one element otherwise.  The
// TPU kernel cuts the weight into 256-wide tiles that must divide it, and
// the reference falls back to XLA for odd or prime dims; here the loop
// bounds are the only mask, so every shape with an even `axis` takes the
// kernel.  Axis 0 is a flat pass (out[o] = w0 * (w[o] + w[o + half*cols]));
// axis 1 pairs columns within each row.

#include "common.cuh"

namespace reprotorch {
namespace {

// out[row, col] = w0 * (w[row * w_in + col] + w[row * w_in + col + b_off])
// for row < n_out / w_out, col < w_out.  VEC divides w_out, w_in and b_off.
template <typename T, int VEC>
__global__ void __launch_bounds__(kElementwiseThreads)
coalesce_pair_kernel(const T* __restrict__ w, T* __restrict__ out, int64_t n_out,
                     int64_t w_out, int64_t w_in, int64_t b_off, float w0) {
  const int64_t n_vec = n_out / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t vi = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       vi < n_vec; vi += stride) {
    const int64_t o = vi * VEC;
    const int64_t row = o / w_out;
    const int64_t ia = row * w_in + (o - row * w_out);
    alignas(16) T a[VEC];
    alignas(16) T b[VEC];
    alignas(16) T y[VEC];
    load_vec<T, VEC>(a, w + ia);
    load_vec<T, VEC>(b, w + ia + b_off);
#pragma unroll
    for (int e = 0; e < VEC; ++e) y[e] = from_f32<T>(w0 * (to_f32(a[e]) + to_f32(b[e])));
    store_vec<T, VEC>(out + o, y);
  }
}

template <typename T>
cudaError_t launch_pair(const void* w, void* out, long long rows, long long cols,
                        int axis, float w0, cudaStream_t stream) {
  const int64_t half = (axis == 0 ? rows : cols) / 2;
  const int64_t n_out = axis == 0 ? half * cols : rows * half;
  const int64_t w_out = axis == 0 ? n_out : half;
  const int64_t w_in = axis == 0 ? n_out : cols;
  const int64_t b_off = axis == 0 ? n_out : half;
  constexpr int V = vec16<T>();
  const T* src = static_cast<const T*>(w);
  T* dst = static_cast<T*>(out);
  if (w_out % V == 0 && w_in % V == 0 && b_off % V == 0 && aligned16(w) &&
      aligned16(out)) {
    coalesce_pair_kernel<T, V><<<elementwise_blocks(n_out / V), kElementwiseThreads, 0,
                                 stream>>>(src, dst, n_out, w_out, w_in, b_off, w0);
  } else {
    coalesce_pair_kernel<T, 1><<<elementwise_blocks(n_out), kElementwiseThreads, 0,
                                 stream>>>(src, dst, n_out, w_out, w_in, b_off, w0);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// w [rows, cols] contiguous; out [rows/2, cols] (axis 0) or [rows, cols/2]
// (axis 1) contiguous.  The coalesced axis must be even.  Returns the
// cudaError_t of the launch.
extern "C" int coalesce_pair(const void* w, void* out, int dtype, long long rows,
                             long long cols, int axis, float w0, void* stream) {
  if (rows <= 0 || cols <= 0 || (axis != 0 && axis != 1) ||
      (axis == 0 ? rows : cols) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_pair<float>(w, out, rows, cols, axis, w0, s);
  if (dtype == kBFloat16)
    return launch_pair<__nv_bfloat16>(w, out, rows, cols, axis, w0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
