// Flash attention backward for Hopper (sm_90a): dq, then dk and dv.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`,
// launched by `_bwd_call` in src/repro/kernels/flash_attention.py.  Same
// function, the flash recipe: P is recomputed per tile from the forward's
// saved log-sum-exp, delta = rowsum(dO * O), dS = P * (dP - delta) * scale,
// dQ = dS K, dK = dS^T Q, dV = P^T dO, all accumulated in f32, with the
// outputs in the input type and no S x T matrix in device memory.
//
// What bounds it on this card: operations.  At B = 8, S = T = 1024, H = 12,
// D = 64, causal, the backward needs ~10 D flops per (query, key) pair
// (S, dP, dQ, dK, dV) against ~100 MB of inputs and outputs, far above the
// H100's ~295 FLOP/byte ridge, so the floor is the tensor-core rate.  This
// two-kernel design recomputes S and dP in both kernels: ~14 D per pair.
//
// What this design does about it, and what it leaves for later: this first
// version is written to be right and simple, in the manner of the forward
// (csrc/flash_attention_fwd.cu): f32 FMAs on the CUDA cores from shared
// memory, 4x4 register tiles per thread, one code path for bf16 and f32.
// It runs far below the tensor-core floor.  What it keeps from the recipe:
//   * dq: one block per (batch*head, 64-row query tile), looping over key
//     tiles up to the diagonal; it also computes delta for its rows, writes
//     it out for the dk/dv kernel, and keeps it in shared memory.
//   * dk/dv: one block per (batch*kv head, 64-key tile), looping over the
//     query tiles from the diagonal on, and over the G query heads of its
//     kv head, so the GQA sum happens in the block: no atomics, and the
//     result is the same on every run.
// The TPU grid's sequential axes become loops inside the block.  K/V are
// read for kv head h / G through the strides of the layer layout
// [B, S, H, D] (no broadcast copy, no transposes), and ragged tails are
// masked, so any S and T work (the TPU kernels need tile-divisible shapes).
// Next steps (later PRs): bf16 mma/wgmma tiles, one fused kernel.

#include <math.h>

#include "common.cuh"

namespace reprotorch {
namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 rows x 4 cols of a tile

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * kBQ * (D + 1)    // Q, dO tiles, padded rows
         + 2 * kBK * (D + 1)  // K, V tiles, padded rows
         + kBQ * (kBK + 1)    // dS tile
         + 2 * kBQ;           // lse, delta of the tile's rows
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * kBK * (D + 1)        // K, V tiles
         + 2 * kBQ * (D + 1)      // Q, dO tiles
         + 2 * kBQ * (kBK + 1)    // P, dS tiles
         + 2 * kBQ;               // lse, delta
}

// Scores S = Q K^T and dP = dO V^T for rows ty + 16 i and keys tx + 16 j of
// the staged tiles (pitch QP).
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int QP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * QP + d];
      ov[i] = dOs[(ty + 16 * i) * QP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * QP + d];
      vv[j] = Vs[(tx + 16 * j) * QP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// Stage `n` rows of a [*, D] operand starting at row `r0` (row stride `rs`,
// rows past `limit` zeroed) into shared memory with pitch D + 1.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0, int limit,
                                           int64_t rs, int n) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int p = r0 + r;
    dst[r * (D + 1) + d] = p < limit ? to_f32(src[p * rs + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int S, int T_len,
                    int H, int G, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                    int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
                    float scale, int causal) {
  constexpr int QP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int NJ = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * QP;
  float* Ks = dOs + kBQ * QP;
  float* Vs = Ks + kBK * QP;
  float* dSs = Vs + kBK * QP;
  float* lse_s = dSs + kBQ * PP;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / G;
  const int q0 = blockIdx.x * kBQ;
  const int64_t rs = static_cast<int64_t>(H) * D;  // row stride of out/dout/dq
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;  // lse/delta row

  stage_rows<T, D>(Qs, q + b * sqb + h * sqh, q0, S, sqs, kBQ);
  stage_rows<T, D>(dOs, dout + base, q0, S, rs, kBQ);
  __syncthreads();
  {  // delta = rowsum(dO * O): 4 neighbouring lanes per row
    const int r = tid / 4, part = tid % 4;
    const int qp = q0 + r;
    float sum = 0.f;
    if (qp < S) {
      const T* orow = out + base + qp * rs;
      for (int d = part; d < D; d += 4) sum = fmaf(dOs[r * QP + d], to_f32(orow[d]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      lse_s[r] = qp < S ? lse[row0 + qp] : 0.f;
      if (qp < S) delta[row0 + qp] = sum;
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int t_end = causal ? min(T_len, q0 + kBQ) : T_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K and dS reads are finished
    stage_rows<T, D>(Ks, k + b * skb + kh * skh, k0, T_len, skt, kBK);
    stage_rows<T, D>(Vs, v + b * svb + kh * svh, k0, T_len, svt, kBK);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = qp < S && kp < T_len && (!causal || kp <= qp);
        const float p = ok ? __expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * PP + c] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // dq += dS K for rows ty + 16 i and columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[c * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    T* drow = dq + base + qp * rs;
#pragma unroll
    for (int j = 0; j < NJ; ++j) drow[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H,
                     int KH, int G, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                     int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
                     float scale, int causal) {
  constexpr int QP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int NJ = D / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * QP;
  float* Qs = Vs + kBK * QP;
  float* dOs = Qs + kBQ * QP;
  float* Ps = dOs + kBQ * QP;
  float* dSs = Ps + kBQ * PP;
  float* lse_s = dSs + kBQ * PP;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int k0 = blockIdx.x * kBK;
  const int64_t rs = static_cast<int64_t>(H) * D;  // row stride of dout

  stage_rows<T, D>(Ks, k + b * skb + kh * skh, k0, T_len, skt, kBK);
  stage_rows<T, D>(Vs, v + b * svb + kh * svh, k0, T_len, svt, kBK);

  float dk_acc[4][NJ], dv_acc[4][NJ];  // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: rows before this key tile's first key attend none of its keys
  const int qt0 = causal ? k0 / kBQ : 0;
  const int n_qt = (S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * sqb + h * sqh;
    const T* ob = dout + (static_cast<int64_t>(b) * S * H + h) * D;
    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's Q/dO/P/dS reads are finished
      stage_rows<T, D>(Qs, qb, q0, S, sqs, kBQ);
      stage_rows<T, D>(dOs, ob, q0, S, rs, kBQ);
      if (tid < kBQ) {
        const int qp = q0 + tid;
        lse_s[tid] = qp < S ? lse[row0 + qp] : 0.f;
        delta_s[tid] = qp < S ? delta[row0 + qp] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qp = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int kp = k0 + c;
          const bool ok = qp < S && kp < T_len && (!causal || kp <= qp);
          const float p = ok ? __expf(s[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * PP + c] = p;
          dSs[r * PP + c] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q for keys ty + 16 i and columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], dsv[4], ov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * PP + ty + 16 * i];
          dsv[i] = dSs[r * PP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ov[j] = dOs[r * QP + tx + 16 * j];
          qv[j] = Qs[r * QP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= T_len) continue;
    const int64_t o = ((static_cast<int64_t>(b) * T_len + kp) * KH + kh) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[o + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dv[o + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, void* delta, void* dq, int B,
                      int S, int T_len, int H, int G, const int64_t* st, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq), S,
      T_len, H, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B,
                       int S, int T_len, int H, int KH, const int64_t* st, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kBK - 1) / kBK, B * KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, T_len,
      H, KH, H / KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int T_len, int H, int KH) {
  return B <= 0 || S <= 0 || T_len <= 0 || KH <= 0 || H % KH != 0 ||
         static_cast<long long>(B) * H > 65535;
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// q [B,S,H,D], k/v [B,T,KH,D] by the strides given (last dim contiguous);
// out, dout, dq [B,S,H,D] and lse, delta [B,H,S] f32 contiguous.  Writes dq
// and delta = rowsum(dout * out).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* delta, void* dq, int dtype, int B, int S,
                                      int T_len, int H, int KH, int D, long long sqb,
                                      long long sqs, long long sqh, long long skb,
                                      long long skt, long long skh, long long svb,
                                      long long svt, long long svh, float scale,
                                      int causal, void* stream) {
  if (bad_shape(B, S, T_len, H, KH)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch_dq<float, 64>(q, k, v, out, dout, lse, delta, dq, B, S, T_len, H, G, st,
                                scale, causal, s);
  if (dtype == kFloat32 && D == 128)
    return launch_dq<float, 128>(q, k, v, out, dout, lse, delta, dq, B, S, T_len, H, G, st,
                                 scale, causal, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, out, dout, lse, delta, dq, B, S, T_len, H,
                                        G, st, scale, causal, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, out, dout, lse, delta, dq, B, S, T_len,
                                         H, G, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Same inputs (delta from flash_attention_bwd_dq); dk, dv [B,T,KH,D]
// contiguous, each summed over the G query heads of its kv head.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B, int S,
                                       int T_len, int H, int KH, int D, long long sqb,
                                       long long sqs, long long sqh, long long skb,
                                       long long skt, long long skh, long long svb,
                                       long long svt, long long svh, float scale,
                                       int causal, void* stream) {
  if (bad_shape(B, S, T_len, H, KH)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H, KH, st,
                                 scale, causal, s);
  if (dtype == kFloat32 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H, KH, st,
                                  scale, causal, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H,
                                         KH, st, scale, causal, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, T_len,
                                          H, KH, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
