// Paged-attention decode for Hopper (sm_90a): one query token per sequence,
// K/V read through a block table from a shared page pool.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`, launched by
// `paged_attention_decode` in src/repro/kernels/paged_attention.py.  Same
// function: positions >= length are masked, pages past ceil(len/P) are never
// touched (nor are their block-table entries read), and a length-0 row (an
// idle decode slot) gives exact zeros.
//
// What bounds it on this card: bytes.  Each (sequence, kv head) pair reads
// len x D keys and values once and does 4 G flops per key element, about
// 2 flop per byte in bf16 at G = 8, far below the ~295 flop/byte ridge.
// At B = 8 and len ~ 1000 the floor is ~8 MB at 3.35 TB/s, ~2.4 us.
//
// What this design does about it: the TPU grid's scalar-prefetched block
// table becomes a per-block read of the table row; the sequential page axis
// becomes a loop inside the block that carries the f32 online softmax for
// the G query heads that share this kv head, so every K/V byte is read once
// for all G heads (the GQA saving).  Each iteration stages 64 positions
// (whole pages) in shared memory.  Left for later: one block per
// (sequence, kv head) is only B x KH = 32 blocks at the serving shape, a
// quarter of the 132 SMs, so the rate is far from the memory bound; the
// known cure is to split the pages of a sequence over several blocks and
// merge their partial softmax states (flash-decoding).

#include <math.h>

#include "common.cuh"

namespace reprotorch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerIter = 64;

size_t paged_smem_bytes(int G, int D, int CK, int NPG) {
  return sizeof(float) * (static_cast<size_t>(G) * D  // q, pre-scaled
                          + CK * (D + 1)              // K positions, padded rows
                          + CK * D                    // V positions
                          + G * CK                    // scores, then probabilities
                          + G * D                     // f32 accumulator
                          + 3 * G)                    // m, l, per-step rescale
         + sizeof(int) * NPG;                         // page ids of this step
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int KH,
                    int G, int P, int M, int NPG, float scale) {
  extern __shared__ float smem[];
  const int CK = NPG * P;
  float* Qs = smem;
  float* Ks = Qs + G * D;
  float* Vs = Ks + CK * (D + 1);
  float* Ss = Vs + CK * D;
  float* As = Ss + G * CK;
  float* m_s = As + G * D;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* pid_s = reinterpret_cast<int*>(c_s + G);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int64_t head = (static_cast<int64_t>(b) * KH + kh) * G * D;
  T* ob = out + head;
  const int len = min(lengths[b], M * P);
  if (len <= 0) {  // idle row: exact zeros, no K/V or table read
    for (int i = tid; i < G * D; i += kThreads) ob[i] = from_f32<T>(0.f);
    return;
  }
  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_f32(q[head + i]) * scale;
    As[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int n_pages = (len + P - 1) / P;
  const int64_t tok = static_cast<int64_t>(KH) * D;  // one position of a page
  const int64_t page = tok * P;                        // one page
  for (int m0 = 0; m0 < n_pages; m0 += NPG) {
    __syncthreads();  // the previous step's reads of the staging buffers are done
    for (int i = tid; i < NPG; i += kThreads)
      pid_s[i] = m0 + i < n_pages ? tables[static_cast<int64_t>(b) * M + m0 + i] : 0;
    __syncthreads();
    const int base = m0 * P;                  // first position of this step
    const int n_valid = min(CK, len - base);  // positions < len in this step
    for (int i = tid; i < CK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (c < n_valid) {
        const int64_t ix = pid_s[c / P] * page + (c % P) * tok + kh * D + d;
        kv = to_f32(k_pages[ix]);
        vv = to_f32(v_pages[ix]);
      }
      Ks[c * (D + 1) + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < G * CK; i += kThreads) {
      const int g = i / CK, c = i % CK;
      float s = -INFINITY;
      if (c < n_valid) {
        const float* qr = Qs + g * D;
        const float* kr = Ks + c * (D + 1);
        s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      Ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* srow = Ss + g * CK;
      float mx = -INFINITY;
      for (int c = lane; c < n_valid; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < n_valid; c += 32) {
        const float p = __expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : __expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = corr * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* prow = Ss + g * CK;
      float a = As[i] * c_s[g];
      for (int c = 0; c < n_valid; ++c) a = fmaf(prow[c], Vs[c * D + d], a);
      As[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads)
    ob[i] = from_f32<T>(As[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* k_pages, const void* v_pages,
                         const int* tables, const int* lengths, void* out, int B,
                         int KH, int G, int P, int M, float scale,
                         cudaStream_t stream) {
  const int NPG = P >= kKeysPerIter ? 1 : kKeysPerIter / P;
  const size_t smem = paged_smem_bytes(G, D, NPG * P, NPG);
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * KH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, lengths, static_cast<T*>(out), KH, G,
      P, M, NPG, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// q [B,KH,G,D], pages [N,P,KH,D] (K and V), out [B,KH,G,D], all contiguous;
// block_tables [B,M] and lengths [B] int32.  Returns the launch's cudaError_t.
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* block_tables,
                                      const void* lengths, void* out, int dtype, int B,
                                      int KH, int G, int D, int P, int M, float scale,
                                      void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || P <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch_paged<float, 64>(q, k_pages, v_pages, bt, ln, out, B, KH, G, P, M, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_paged<float, 128>(q, k_pages, v_pages, bt, ln, out, B, KH, G, P, M, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_paged<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, ln, out, B, KH, G, P, M,
                                           scale, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_paged<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, ln, out, B, KH, G, P, M,
                                            scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
