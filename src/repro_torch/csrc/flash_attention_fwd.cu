// Flash attention forward for Hopper (sm_90a): out and log-sum-exp.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by `_fwd_call` in
// src/repro/kernels/flash_attention.py.  Same function: an online softmax
// over key tiles with f32 (m, l, acc) state, causal tiles past the diagonal
// skipped, `out` in the input type and `lse` in f32.
//
// What bounds it on this card: operations.  Prefill attention at S = 1536,
// H = 32, D = 64 does ~9.7 GFLOP causal and moves ~13 MB, far above the
// H100's ~295 FLOP/byte ridge, so the floor is the tensor-core rate.
//
// What this design does about it, and what it leaves for later: this first
// version is written to be right and simple.  It computes in f32 on the CUDA
// cores (scalar FMAs from shared memory, a 4x4 register tile of scores per
// thread), which keeps one code path for bf16 and f32 inputs and meets the
// f32 tolerance exactly, but runs far below the tensor-core floor.  What it
// does keep from the flash recipe: Q, the K/V tile and the probabilities
// stay in shared memory, no S x T score matrix touches device memory, and
// the causal loop stops at the diagonal, so half the tiles are never
// loaded.  The TPU's sequential k-block grid axis becomes a loop inside the
// block; one block per (batch*head, 64-row query tile).  GQA reads K/V head
// h / G in place (no broadcast copy), and the strides of the layer layout
// [B, S, H, D] are taken as given, so the caller makes no transposes.
// Next steps (later PRs): bf16 mma/wgmma tiles fed by TMA.

#include <math.h>

#include "common.cuh"

namespace reprotorch {
namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 rows x 4 key cols

template <int D>
constexpr size_t flash_smem_floats() {
  return kBQ * (D + 1)      // Q tile (pre-scaled), padded rows
         + kBK * (D + 1)    // K tile, padded rows
         + kBK * D          // V tile
         + kBQ * (kBK + 1)  // scores, then probabilities
         + 3 * kBQ;         // m, l, per-tile rescale factor
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_len, int H, int G,
                 int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                 int64_t skt, int64_t skh, int64_t svb, int64_t svt,
                 int64_t svh, float scale, int causal) {
  constexpr int QP = D + 1;    // padded row pitch of Q and K
  constexpr int PP = kBK + 1;  // padded row pitch of the score tile
  constexpr int NJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QP;
  float* Vs = Ks + kBK * QP;
  float* Ps = Vs + kBK * D;
  float* m_s = Ps + kBQ * PP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / G;
  const int q0 = blockIdx.x * kBQ;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + kh * skh;
  const T* vb = v + b * svb + kh * svh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    Qs[r * QP + d] = qp < S ? to_f32(qb[qp * sqs + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // causal: no row of this tile attends a key past its last row
  const int t_end = causal ? min(T_len, q0 + kBQ) : T_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V/P reads are finished
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kp = k0 + c;
      const bool ok = kp < T_len;
      Ks[c * QP + d] = ok ? to_f32(kb[kp * skt + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f32(vb[kp * svt + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = kp < T_len && (!causal || kp <= q0 + r);
        Ps[r * PP + c] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 4 neighbouring lanes per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* prow = Ps + r * PP;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float sv = prow[c];
        const float p = sv == -INFINITY ? 0.f : __expf(sv - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = m_old == -INFINITY ? 0.f : __expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V for rows ty + 16 i and columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    if (tx == 0) lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int S, int T_len, int H, int G,
                         const int64_t* st, float scale, int causal,
                         cudaStream_t stream) {
  const size_t smem = flash_smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), S, T_len, H, G, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// q [B,S,H,D], k [B,T,KH,D], v [B,T,KH,D] (last dim contiguous, other dims
// by the strides given, in elements); out [B,S,H,D] and lse [B,H,S] f32
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int dtype, int B, int S,
                                   int T_len, int H, int KH, int D, long long sqb,
                                   long long sqs, long long sqh, long long skb,
                                   long long skt, long long skh, long long svb,
                                   long long svt, long long svh, float scale,
                                   int causal, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || KH <= 0 || H % KH != 0 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch_flash<float, 64>(q, k, v, out, lse, B, S, T_len, H, G, st, scale, causal, s);
  if (dtype == kFloat32 && D == 128)
    return launch_flash<float, 128>(q, k, v, out, lse, B, S, T_len, H, G, st, scale, causal, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_flash<__nv_bfloat16, 64>(q, k, v, out, lse, B, S, T_len, H, G, st, scale,
                                           causal, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_flash<__nv_bfloat16, 128>(q, k, v, out, lse, B, S, T_len, H, G, st, scale,
                                            causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* reprotorch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
