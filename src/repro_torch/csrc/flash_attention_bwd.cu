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
// two-kernel design recomputes S and dP in both kernels: ~14 D per pair
// (dq 6 D, dk/dv 8 D).
//
// The two launches, and what each design does about that bound:
//   * dq, bf16 (`flash_bwd_dq_mma_kernel`), on the tensor cores.  One block
//     of 4 warps per (batch * head, 64-row query tile), longest causal
//     tiles first; each warp owns 16 query rows, the m of one m16n8k16
//     tile, across every key tile, so S, P, dP, dS and the dQ accumulator
//     never leave registers.  Q and dO arrive once by cp.async into
//     XOR-swizzled shared memory (at D = 64 their A fragments then stay in
//     registers for the whole loop; at D = 128 they are read per k-step, as
//     holding them would spill); lse and delta are per-row registers.  The
//     block first computes delta = rowsum(dO * O) in f32 from the staged dO
//     and O read from global memory, and writes it out for the dk/dv
//     kernel.  K and V tiles of 64 keys are double-buffered by cp.async,
//     the next one in flight while this one is computed, with one
//     __syncthreads per tile, up to the diagonal when causal.  Per tile:
//     S = Q K^T, P = exp2(S scale log2(e) - lse log2(e)) (masked entries
//     exactly 0), dP = dO V^T, dS = P (dP - delta) packed to bf16 A
//     fragments in registers, dQ += dS K with K as the k-major operand
//     through ldmatrix.trans.  `scale` is applied to dQ once, at the end,
//     and dQ leaves in 16-byte rows staged through the warp's own rows of
//     the Q tile.  Each block owns its rows and uses no atomics, so two
//     launches give the same bits.
//   * dq, f32 (`flash_bwd_dq_kernel`): the first design, kept for f32
//     only: f32 FMAs on the CUDA cores from shared memory with 4x4
//     register tiles per thread, the same grid and the same delta.
//   * dk/dv, bf16 (`flash_bwd_dkv_mma_kernel`), on the tensor cores.  One
//     block of 4 warps per (batch, kv head, 64-key tile), looping over the
//     G query heads of its kv head and over the query tiles from the
//     diagonal on, so the GQA sum happens in the block: no atomics, and the
//     result is the same on every run.  Each warp owns 16 keys.  K and V
//     stay in XOR-swizzled shared memory for the whole loop; Q, dO, lse and
//     delta tiles are double-buffered by cp.async, the next one in flight
//     while this one is computed, with one __syncthreads per tile.  Each
//     tile is computed transposed, so that every product's A operand is an
//     accumulator already in registers: S^T = K Q^T, P^T = exp2(S^T scale
//     log2(e) - lse log2(e)) (masked entries exactly 0), dV += P^T dO,
//     dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q, all
//     mma.sync m16n8k16 with f32 accumulation; P^T and dS^T are packed to
//     bf16 in registers, Q and dO come by ldmatrix (.trans where they are
//     the k-major operand).  `scale` is applied to dK once, at the end.
//   * dk/dv, f32 (`flash_bwd_dkv_kernel`): the first design, kept for f32
//     only.
// In both types tensor cores in f32 would mean TF32, which would break the
// f32 parity the training checks hold, so f32 stays on the scalar bodies.
// In every mma body only tiles that cross the diagonal or a ragged end take
// the masking branch, which is warp-uniform: an if-converted mask costs
// every tile more instructions than its tensor-core products.
// The causal mask is aligned at a query offset, as the forward's: row r may
// read key j iff j <= q_off + r.  dq's key loop ends at the last row's
// limit; dk/dv's query loop starts at the first tile whose last row reaches
// the key tile; only tiles that cross the diagonal take the mask.
// Head dims: every body is a template on the query/key head dim DQK and the
// value head dim DV (the TPU kernels take any Dqk and a separate Dv); the
// entry points instantiate (64, 64), (128, 128) and MLA's (192, 128)
// (DeepSeek-V3: nope 128 + rope 64, v 128).  S and dQ, dK run over DQK; dP,
// dV and delta = rowsum(dO * O) over DV.  At (192, 128) the dk/dv body would
// hold 24 + 16 accumulator tiles (160 f32 registers a thread) beside its
// score fragments under the 255 cap, so for that shape alone the entry point
// runs it twice, the PART template argument choosing what a pass
// accumulates: dV first (P^T recomputed), then dK (P^T and dP^T recomputed),
// each pass holding only its own accumulator.  That costs one more S^T = K Q^T
// per tile, in place of spilling the accumulators of a tensor-core body.
// The dq body at (192, 128) likewise runs twice, each launch accumulating
// one half of dQ's columns (COL) and recomputing S and dP, with a tile's
// keys taken 32 at a time (SUB): one launch holding all 24 dQ n-tiles
// beside S, dP and their operand fragments spilled at the 255 cap.
// The TPU grid's sequential axes become loops inside the block.  K/V are
// read for kv head h / G through the strides of the layer layout
// [B, S, H, D] (no broadcast copy, no transposes), and ragged tails are
// masked, so any S and T work (the TPU kernels need tile-divisible shapes).
// Next steps: one fused kernel (10 D flops per pair instead of 14 D), then
// wgmma fed by TMA.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace reprotorch {
namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 rows x 4 cols of a tile

template <int DQK, int DV>
constexpr size_t dq_smem_floats() {
  return kBQ * (DQK + 1) + kBQ * (DV + 1)    // Q, dO tiles, padded rows
         + kBK * (DQK + 1) + kBK * (DV + 1)  // K, V tiles, padded rows
         + kBQ * (kBK + 1)                   // dS tile
         + 2 * kBQ;                          // lse, delta of the tile's rows
}

template <int DQK, int DV>
constexpr size_t dkv_smem_floats() {
  return kBK * (DQK + 1) + kBK * (DV + 1)    // K, V tiles
         + kBQ * (DQK + 1) + kBQ * (DV + 1)  // Q, dO tiles
         + 2 * kBQ * (kBK + 1)               // P, dS tiles
         + 2 * kBQ;                          // lse, delta
}

// Scores S = Q K^T and dP = dO V^T for rows ty + 16 i and keys tx + 16 j of
// the staged tiles (Q and K at pitch DQK + 1, dO and V at DV + 1).
template <int DQK, int DV>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int QP = DQK + 1, OP = DV + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  if constexpr (DQK == DV) {
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
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
  } else {
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
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
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = dOs[(ty + 16 * i) * OP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * OP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
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

// f32 dq body (instantiated for f32 only; bf16 takes the mma body below).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int S, int T_len,
                    int H, int G, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                    int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
                    float scale, int causal, int q_off) {
  constexpr int QP = DQK + 1, OP = DV + 1;
  constexpr int PP = kBK + 1;
  constexpr int NJ = DQK / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * QP;
  float* Ks = dOs + kBQ * OP;
  float* Vs = Ks + kBK * QP;
  float* dSs = Vs + kBK * OP;
  float* lse_s = dSs + kBQ * PP;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / G;
  const int q0 = blockIdx.x * kBQ;
  const int64_t rs = static_cast<int64_t>(H) * DV;  // row stride of out/dout
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * DV;
  const int64_t rsq = static_cast<int64_t>(H) * DQK;  // row stride of dq
  const int64_t base_q = (static_cast<int64_t>(b) * S * H + h) * DQK;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;  // lse/delta row

  stage_rows<T, DQK>(Qs, q + b * sqb + h * sqh, q0, S, sqs, kBQ);
  stage_rows<T, DV>(dOs, dout + base, q0, S, rs, kBQ);
  __syncthreads();
  {  // delta = rowsum(dO * O): 4 neighbouring lanes per row
    const int r = tid / 4, part = tid % 4;
    const int qp = q0 + r;
    float sum = 0.f;
    if (qp < S) {
      const T* orow = out + base + qp * rs;
      for (int d = part; d < DV; d += 4) sum = fmaf(dOs[r * OP + d], to_f32(orow[d]), sum);
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

  const int t_end = causal ? min(T_len, q_off + q0 + kBQ) : T_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K and dS reads are finished
    stage_rows<T, DQK>(Ks, k + b * skb + kh * skh, k0, T_len, skt, kBK);
    stage_rows<T, DV>(Vs, v + b * svb + kh * svh, k0, T_len, svt, kBK);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DQK, DV>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = qp < S && kp < T_len && (!causal || kp <= q_off + qp);
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
    T* drow = dq + base_q + qp * rsq;
#pragma unroll
    for (int j = 0; j < NJ; ++j) drow[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// f32 dk/dv body (instantiated for f32 only; bf16 takes the mma body below).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H,
                     int KH, int G, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                     int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
                     float scale, int causal, int q_off) {
  constexpr int QP = DQK + 1, OP = DV + 1;
  constexpr int PP = kBK + 1;
  constexpr int NK = DQK / 16;  // dk columns per thread
  constexpr int NV = DV / 16;   // dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * QP;
  float* Qs = Vs + kBK * OP;
  float* dOs = Qs + kBQ * QP;
  float* Ps = dOs + kBQ * OP;
  float* dSs = Ps + kBQ * PP;
  float* lse_s = dSs + kBQ * PP;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int k0 = blockIdx.x * kBK;
  const int64_t rs = static_cast<int64_t>(H) * DV;  // row stride of dout

  stage_rows<T, DQK>(Ks, k + b * skb + kh * skh, k0, T_len, skt, kBK);
  stage_rows<T, DV>(Vs, v + b * svb + kh * svh, k0, T_len, svt, kBK);

  float dk_acc[4][NK], dv_acc[4][NV];  // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NK; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) dv_acc[i][j] = 0.f;
  }

  // causal: rows r with q_off + r below this key tile's first key attend
  // none of its keys
  const int qt0 = causal ? max(k0 - q_off, 0) / kBQ : 0;
  const int n_qt = (S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * sqb + h * sqh;
    const T* ob = dout + (static_cast<int64_t>(b) * S * H + h) * DV;
    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's Q/dO/P/dS reads are finished
      stage_rows<T, DQK>(Qs, qb, q0, S, sqs, kBQ);
      stage_rows<T, DV>(dOs, ob, q0, S, rs, kBQ);
      if (tid < kBQ) {
        const int qp = q0 + tid;
        lse_s[tid] = qp < S ? lse[row0 + qp] : 0.f;
        delta_s[tid] = qp < S ? delta[row0 + qp] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<DQK, DV>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qp = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int kp = k0 + c;
          const bool ok = qp < S && kp < T_len && (!causal || kp <= q_off + qp);
          const float p = ok ? __expf(s[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * PP + c] = p;
          dSs[r * PP + c] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q for keys ty + 16 i and columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], dsv[4], ov[NV], qv[NK];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * PP + ty + 16 * i];
          dsv[i] = dSs[r * PP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) ov[j] = dOs[r * OP + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < NK; ++j) qv[j] = Qs[r * QP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NV; ++j) dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
#pragma unroll
          for (int j = 0; j < NK; ++j) dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= T_len) continue;
    const int64_t o = (static_cast<int64_t>(b) * T_len + kp) * KH + kh;
#pragma unroll
    for (int j = 0; j < NK; ++j) dk[o * DQK + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
#pragma unroll
    for (int j = 0; j < NV; ++j) dv[o * DV + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dk/dv body on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 keys each
static_assert(kMmaThreads == 2 * kBQ, "one thread per lse and per delta entry of a tile");

template <int DQK, int DV>
constexpr size_t dkv_mma_smem_bytes() {
  return (kBK * (DQK + DV) + 2 * kBQ * (DQK + DV)) * sizeof(bf16)  // K, V; Q, dO twice
         + 2 * 2 * kBQ * sizeof(float);                          // lse, delta twice
}

// PART: kPartDV | kPartDK, what this launch accumulates and writes.  Both,
// except at (192, 128), where the entry point runs a dV pass and a dK pass.
constexpr int kPartDV = 1, kPartDK = 2;

template <int DQK, int DV, int PART>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int T_len,
                         int H, int KH, int G, int64_t sqb, int64_t sqs, int64_t sqh,
                         int64_t skb, int64_t skt, int64_t skh, int64_t svb, int64_t svt,
                         int64_t svh, float scale, int causal, int q_off) {
  constexpr bool kDV = PART & kPartDV, kDK = PART & kPartDK;
  constexpr int KSQ = DQK / 16;  // k-steps over the query/key head dim
  constexpr int KSV = DV / 16;   // k-steps over the value head dim
  constexpr int NDK = DQK / 8;   // n-tiles of a dK row block
  constexpr int NDV = DV / 8;    // n-tiles of a dV row block
  constexpr int NQ = kBQ / 8;    // n-tiles of a transposed score row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBK * DQK;
  bf16* Qs = Vs + kBK * DV;         // two stages of [kBQ, DQK]
  bf16* dOs = Qs + 2 * kBQ * DQK;   // two stages of [kBQ, DV]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kBQ * DV);  // two stages of kBQ
  float* delta_s = lse_s + 2 * kBQ;                              // two stages of kBQ

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int k0 = blockIdx.x * kBK;
  const int key0 = k0 + 16 * warp;  // this warp's first key
  const int64_t rs = static_cast<int64_t>(H) * DV;  // row stride of dout
  const float scale_log2 = scale * kLog2e;

  // causal: rows r with q_off + r below this key tile's first key attend
  // none of its keys
  const int qt0 = causal ? max(k0 - q_off, 0) / kBQ : 0;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int per_head = max(n_qt - qt0, 0);
  const int n_iter = G * per_head;  // (query head, query tile) pairs, head-major

  auto prefetch = [&](int it) {  // Q, dO, lse, delta of pair `it` into stage it % 2
    const int h = kh * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * kBQ;
    const int st = it & 1;
    cp_async_tile<DQK, kBQ, kMmaThreads>(Qs + st * kBQ * DQK, q + b * sqb + h * sqh + q0 * sqs,
                                         sqs, S - q0);
    cp_async_tile<DV, kBQ, kMmaThreads>(dOs + st * kBQ * DV,
                                        dout + (static_cast<int64_t>(b) * S + q0) * rs + h * DV,
                                        rs, S - q0);
    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S + q0;
    const int r = tid % kBQ;
    const bool ok = q0 + r < S;
    const float* src = (tid < kBQ ? lse : delta) + row0 + (ok ? r : 0);
    cp_async4(smem_addr((tid < kBQ ? lse_s : delta_s) + st * kBQ + r), src, ok);
  };

  cp_async_tile<DQK, kBK, kMmaThreads>(Ks, k + b * skb + kh * skh + k0 * skt, skt, T_len - k0);
  cp_async_tile<DV, kBK, kMmaThreads>(Vs, v + b * svb + kh * svh + k0 * svt, svt, T_len - k0);
  if (n_iter > 0) prefetch(0);
  cp_async_commit();

  // keys g, g + 8 of this warp; an accumulator this pass does not keep is
  // one unused tile
  float dk_acc[kDK ? NDK : 1][4], dv_acc[kDV ? NDV : 1][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int d = 0; d < (kDK ? NDK : 1); ++d) dk_acc[d][e] = 0.f;
#pragma unroll
    for (int d = 0; d < (kDV ? NDV : 1); ++d) dv_acc[d][e] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // pair `it` landed; every warp is done with pair it - 1
    if (it + 1 < n_iter) prefetch(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const int q0 = (qt0 + it % per_head) * kBQ;
    const bf16* Qt = Qs + st * kBQ * DQK;
    const bf16* dOt = dOs + st * kBQ * DV;
    const float* ls = lse_s + st * kBQ;
    const float* dl = delta_s + st * kBQ;

    // S^T = K Q^T: rows are this warp's keys, columns the tile's queries
    float p[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSQ; ++ks) {
      uint32_t ka[4];
      ldmatrix_x4(ka, smem_addr(Ks + swz<DQK>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))));
#pragma unroll
      for (int qn = 0; qn < NQ / 2; ++qn) {
        uint32_t bq[4];
        ldmatrix_x4(bq, smem_addr(Qt + swz<DQK>(16 * qn + (lane & 7) + ((lane >> 4) << 3),
                                                2 * ks + ((lane >> 3) & 1))));
        mma_bf16(p[2 * qn], ka, bq[0], bq[1]);
        mma_bf16(p[2 * qn + 1], ka, bq[2], bq[3]);
      }
    }
    // P^T = exp(S^T scale - lse), exactly 0 where masked
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = exp2_approx(fmaf(p[n][e], scale_log2, -(e & 1 ? lv.y : lv.x) * kLog2e));
    }
    if ((causal && key0 + 15 > q_off + q0) || q0 + kBQ > S || key0 + 16 > T_len) {
      // only tiles that cross the diagonal or an end: query q0 + qi of key
      // row kp is kept where qi lies in [qlo, qhi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = key0 + g + 8 * r;
        const int qlo = (causal ? kp - q_off : 0) - q0 - 2 * c;
        const int qhi = (kp < T_len ? S : 0) - q0 - 2 * c;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          if (8 * n < qlo || 8 * n >= qhi) p[n][2 * r] = 0.f;
          if (8 * n + 1 < qlo || 8 * n + 1 >= qhi) p[n][2 * r + 1] = 0.f;
        }
      }
    }
    if constexpr (kDV) {
      // dV += P^T dO, k-step over 16 queries
#pragma unroll
      for (int kq = 0; kq < kBQ / 16; ++kq) {
        uint32_t pa[4];
        acc_to_a(pa, p[2 * kq], p[2 * kq + 1]);
#pragma unroll
        for (int dn = 0; dn < NDV / 2; ++dn) {
          uint32_t bo[4];
          ldmatrix_x4_trans(bo, smem_addr(dOt + swz<DV>(16 * kq + (lane & 7) +
                                                            (((lane >> 3) & 1) << 3),
                                                        2 * dn + (lane >> 4))));
          mma_bf16(dv_acc[2 * dn], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * dn + 1], pa, bo[2], bo[3]);
        }
      }
    }
    if constexpr (kDK) {
      // dP^T = V dO^T
      float ds[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSV; ++ks) {
        uint32_t va[4];
        ldmatrix_x4(va, smem_addr(Vs + swz<DV>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))));
#pragma unroll
        for (int qn = 0; qn < NQ / 2; ++qn) {
          uint32_t bo[4];
          ldmatrix_x4(bo, smem_addr(dOt + swz<DV>(16 * qn + (lane & 7) + ((lane >> 4) << 3),
                                                  2 * ks + ((lane >> 3) & 1))));
          mma_bf16(ds[2 * qn], va, bo[0], bo[1]);
          mma_bf16(ds[2 * qn + 1], va, bo[2], bo[3]);
        }
      }
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 dlt = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - (e & 1 ? dlt.y : dlt.x));
      }
      // dK += dS^T Q, k-step over 16 queries
#pragma unroll
      for (int kq = 0; kq < kBQ / 16; ++kq) {
        uint32_t da[4];
        acc_to_a(da, ds[2 * kq], ds[2 * kq + 1]);
#pragma unroll
        for (int dn = 0; dn < NDK / 2; ++dn) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, smem_addr(Qt + swz<DQK>(16 * kq + (lane & 7) +
                                                            (((lane >> 3) & 1) << 3),
                                                        2 * dn + (lane >> 4))));
          mma_bf16(dk_acc[2 * dn], da, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * dn + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  // epilogue: scale dK once; stage each kept result in this warp's own rows
  // of K or V (no other warp reads them), then 16-byte stores of whole rows
  cp_async_wait<0>();
  __syncthreads();  // K and V have landed even where the loop was empty
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if constexpr (kDK) {
#pragma unroll
      for (int d = 0; d < NDK; ++d)
        *reinterpret_cast<uint32_t*>(Ks + swz<DQK>(row, d) + 2 * c) =
            pack_bf16(dk_acc[d][2 * r] * scale, dk_acc[d][2 * r + 1] * scale);
    }
    if constexpr (kDV) {
#pragma unroll
      for (int d = 0; d < NDV; ++d)
        *reinterpret_cast<uint32_t*>(Vs + swz<DV>(row, d) + 2 * c) =
            pack_bf16(dv_acc[d][2 * r], dv_acc[d][2 * r + 1]);
    }
  }
  __syncwarp();
  const int64_t o0 = (static_cast<int64_t>(b) * T_len + k0) * KH + kh;  // (b, key k0, kh)
  if constexpr (kDK) {
    for (int i = lane; i < 16 * (DQK / 8); i += 32) {
      const int row = 16 * warp + i / (DQK / 8), ch = i % (DQK / 8);
      if (k0 + row >= T_len) continue;
      *reinterpret_cast<uint4*>(dk + (o0 + static_cast<int64_t>(row) * KH) * DQK + ch * 8) =
          *reinterpret_cast<const uint4*>(Ks + swz<DQK>(row, ch));
    }
  }
  if constexpr (kDV) {
    for (int i = lane; i < 16 * (DV / 8); i += 32) {
      const int row = 16 * warp + i / (DV / 8), ch = i % (DV / 8);
      if (k0 + row >= T_len) continue;
      *reinterpret_cast<uint4*>(dv + (o0 + static_cast<int64_t>(row) * KH) * DV + ch * 8) =
          *reinterpret_cast<const uint4*>(Vs + swz<DV>(row, ch));
    }
  }
}

template <int DQK, int DV, int PART>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B,
                           int S, int T_len, int H, int KH, const int64_t* st, float scale,
                           int causal, int q_off, cudaStream_t stream) {
  const size_t smem = dkv_mma_smem_bytes<DQK, DV>();
  auto kernel = flash_bwd_dkv_mma_kernel<DQK, DV, PART>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kBK - 1) / kBK, B * KH);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
      T_len, H, KH, H / KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal, q_off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dq body on the tensor cores

template <int DQK, int DV>
constexpr size_t dq_mma_smem_bytes() {
  return (kBQ * (DQK + DV) + 2 * kBK * (DQK + DV)) * sizeof(bf16);  // Q, dO; K, V twice
}

// Two bf16 of one 32-bit word (lo at the lower address) as f32, exactly.
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float dot_bf16x8(uint4 x, uint4 y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = bf16x2_to_f32(xs[i]), b = bf16x2_to_f32(ys[i]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

template <int DQK, int DV, int COL>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ out,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int S, int T_len,
                        int H, int G, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                        int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
                        float scale, int causal, int q_off) {
  constexpr int KS = DQK / 16;  // k-steps over the query/key head dim
  constexpr int KSV = DV / 16;  // k-steps over the value head dim
  // dQ's columns a launch computes: all, or at (192, 128) one half a launch
  // (COL 0, 1), so that its accumulator is 12 n-tiles and not 24 (beside a
  // tile's S and dP and their operands the whole row spilled); each half
  // recomputes S and dP
  constexpr int NCOL = DQK == DV ? 1 : 2;
  constexpr int QC = DQK / NCOL;     // dQ columns of this launch
  constexpr int C0 = COL * QC / 8;   // their first 16-byte chunk in a row
  constexpr int ND = QC / 8;    // n-tiles of a dQ row block
  constexpr int NK = kBK / 8;   // n-tiles of a score row block
  // keys of a tile taken at a time: all 64, or 32 at (192, 128), where
  // S and dP over DQK and DV = 320 columns carry the most operand fragments
  constexpr int SUB = DQK == DV ? 1 : 2;
  constexpr int KB = kBK / SUB;
  constexpr int NKS = NK / SUB;  // n-tiles of a sub-block's score row block
  constexpr int CH = QC / 8;    // 16-byte chunks of a dQ row this launch writes
  constexpr int OC = DV / 32;   // chunks of O per lane of a quad, for delta
  // Q and dO fragments in registers for the whole loop (at 64 only: wider
  // heads would spill)
  constexpr bool kHold = DQK == 64 && DV == 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBQ * DQK;
  bf16* Ks = dOs + kBQ * DV;      // two stages of [kBK, DQK]
  bf16* Vs = Ks + 2 * kBK * DQK;  // two stages of [kBK, DV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int q0 = qt * kBQ;
  const int row0 = q0 + 16 * warp;  // this warp's first query row
  const int64_t rs = static_cast<int64_t>(H) * DV;   // row stride of out, dout
  const int64_t base = static_cast<int64_t>(b) * S * rs + h * DV;  // row 0 of (b, h)
  const int64_t rsq = static_cast<int64_t>(H) * DQK;  // row stride of dq
  const int64_t base_q = static_cast<int64_t>(b) * S * rsq + h * DQK;
  const int64_t srow = (static_cast<int64_t>(b) * H + h) * S;     // lse/delta row 0
  const float scale_log2 = scale * kLog2e;

  const bf16* kb = k + b * skb + kh * skh;
  const bf16* vb = v + b * svb + kh * svh;
  // causal: no row of this tile attends a key past its last row (row r
  // reads keys 0..q_off + r)
  const int t_end = causal ? min(T_len, q_off + q0 + kBQ) : T_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;

  cp_async_tile<DQK, kBQ, kMmaThreads>(Qs, q + b * sqb + h * sqh + q0 * sqs, sqs, S - q0);
  cp_async_tile<DV, kBQ, kMmaThreads>(dOs, dout + base + q0 * rs, rs, S - q0);
  cp_async_tile<DQK, kBK, kMmaThreads>(Ks, kb, skt, T_len);
  cp_async_tile<DV, kBK, kMmaThreads>(Vs, vb, svt, T_len);
  cp_async_commit();

  // rows g and g + 8 of this warp: lse (log2 units) and O's chunks c, c + 4,
  // ... for delta, read while the tiles are in flight
  float lse2[2], dlt[2];
  uint4 o_row[2][OC];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + g + 8 * r;
    lse2[r] = qp < S ? lse[srow + qp] * kLog2e : 0.f;
#pragma unroll
    for (int i = 0; i < OC; ++i)
      o_row[r][i] = qp < S ? __ldg(reinterpret_cast<const uint4*>(out + base + qp * rs +
                                                                    (c + 4 * i) * 8))
                           : make_uint4(0, 0, 0, 0);
  }
  cp_async_wait<0>();
  __syncthreads();  // Q, dO and the first K/V tile have landed
  // delta = rowsum(dO * O) in f32, the 4 lanes of a quad per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < OC; ++i)
      sum = dot_bf16x8(*reinterpret_cast<const uint4*>(dOs + swz<DV>(row, c + 4 * i)),
                       o_row[r][i], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dlt[r] = sum;
    if (COL == 0 && c == 0 && q0 + row < S) delta[srow + q0 + row] = sum;
  }
  uint32_t qf[kHold ? KS : 1][4], of[kHold ? KS : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = swz<DQK>(16 * warp + (lane & 15), 2 * ks + (lane >> 4));
      ldmatrix_x4(qf[ks], smem_addr(Qs + off));
      ldmatrix_x4(of[ks], smem_addr(dOs + off));
    }
  }

  float acc[ND][4];  // dQ of rows g, g + 8 of this warp, unscaled
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_tiles) {  // tile j + 1 into the stage tile j - 1 used
      const int k1 = (j + 1) * kBK;
      const int st = (j + 1) & 1;
      cp_async_tile<DQK, kBK, kMmaThreads>(Ks + st * kBK * DQK, kb + k1 * skt, skt,
                                           T_len - k1);
      cp_async_tile<DV, kBK, kMmaThreads>(Vs + st * kBK * DV, vb + k1 * svt, svt, T_len - k1);
    }
    cp_async_commit();
    const bf16* Kt = Ks + (j & 1) * kBK * DQK;
    const bf16* Vt = Vs + (j & 1) * kBK * DV;
    const int k0 = j * kBK;

    // the tile's keys in SUB sub-blocks of KB: S, dP and dS of one
    // sub-block live at a time (not unrolled, so that the scheduler cannot
    // interleave two sub-blocks and hold both)
#pragma unroll 1
    for (int sb = 0; sb < SUB; ++sb) {
      const int kb0 = sb * KB;  // the sub-block's first key within the tile
      // S = Q K^T and dP = dO V^T
      float s[NKS][4], dp[NKS][4];
#pragma unroll
      for (int n = 0; n < NKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      if constexpr (DQK == DV) {  // one k-loop for both products
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4], oa[4];
          if constexpr (kHold) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              qa[e] = qf[ks][e];
              oa[e] = of[ks][e];
            }
          } else {
            const int off = swz<DQK>(16 * warp + (lane & 15), 2 * ks + (lane >> 4));
            ldmatrix_x4(qa, smem_addr(Qs + off));
            ldmatrix_x4(oa, smem_addr(dOs + off));
          }
#pragma unroll
          for (int kn = 0; kn < NKS / 2; ++kn) {
            const int off = swz<DQK>(kb0 + 16 * kn + (lane & 7) + ((lane >> 4) << 3),
                                     2 * ks + ((lane >> 3) & 1));
            uint32_t bk[4], bv[4];
            ldmatrix_x4(bk, smem_addr(Kt + off));
            mma_bf16(s[2 * kn], qa, bk[0], bk[1]);
            mma_bf16(s[2 * kn + 1], qa, bk[2], bk[3]);
            ldmatrix_x4(bv, smem_addr(Vt + off));
            mma_bf16(dp[2 * kn], oa, bv[0], bv[1]);
            mma_bf16(dp[2 * kn + 1], oa, bv[2], bv[3]);
          }
        }
      } else {  // S over DQK, then dP over DV
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4];
          ldmatrix_x4(qa, smem_addr(Qs + swz<DQK>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))));
#pragma unroll
          for (int kn = 0; kn < NKS / 2; ++kn) {
            uint32_t bk[4];
            ldmatrix_x4(bk, smem_addr(Kt + swz<DQK>(kb0 + 16 * kn + (lane & 7) + ((lane >> 4) << 3),
                                                    2 * ks + ((lane >> 3) & 1))));
            mma_bf16(s[2 * kn], qa, bk[0], bk[1]);
            mma_bf16(s[2 * kn + 1], qa, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < KSV; ++ks) {
          uint32_t oa[4];
          ldmatrix_x4(oa, smem_addr(dOs + swz<DV>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))));
#pragma unroll
          for (int kn = 0; kn < NKS / 2; ++kn) {
            uint32_t bv[4];
            ldmatrix_x4(bv, smem_addr(Vt + swz<DV>(kb0 + 16 * kn + (lane & 7) + ((lane >> 4) << 3),
                                                   2 * ks + ((lane >> 3) & 1))));
            mma_bf16(dp[2 * kn], oa, bv[0], bv[1]);
            mma_bf16(dp[2 * kn + 1], oa, bv[2], bv[3]);
          }
        }
      }
      // P = exp(S scale - lse), exactly 0 where masked
#pragma unroll
      for (int n = 0; n < NKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
      if (k0 + kb0 + KB > T_len || (causal && k0 + kb0 + KB - 1 > q_off + row0)) {
        // only tiles that cross the diagonal or the end of T: a key at or
        // past klim of its row is masked
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + g + 8 * r;
          const int klim = (causal ? min(T_len, q_off + row + 1) : T_len) - (k0 + kb0) - 2 * c;
#pragma unroll
          for (int n = 0; n < NKS; ++n) {
            if (8 * n >= klim) s[n][2 * r] = 0.f;
            if (8 * n + 1 >= klim) s[n][2 * r + 1] = 0.f;
          }
        }
      }
      // dS = P (dP - delta), in place of P
#pragma unroll
      for (int n = 0; n < NKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - dlt[e >> 1];
      // dQ += dS K, k-step over 16 keys, K as the k-major operand
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        uint32_t da[4];
        acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, smem_addr(Kt + swz<DQK>(kb0 + 16 * kk + (lane & 7) +
                                                            (((lane >> 3) & 1) << 3),
                                                        C0 + 2 * dn + (lane >> 4))));
          mma_bf16(acc[2 * dn], da, bk[0], bk[1]);
          mma_bf16(acc[2 * dn + 1], da, bk[2], bk[3]);
        }
      }
    }
  }

  // epilogue: scale dQ once; stage it in this warp's own rows of Qs (no
  // other warp reads them), then 16-byte stores of whole rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(Qs + swz<DQK>(row, C0 + d) + 2 * c) =
          pack_bf16(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
  }
  __syncwarp();
  for (int x = lane; x < 16 * CH; x += 32) {
    const int row = 16 * warp + x / CH, ch = C0 + x % CH;
    const int qp = q0 + row;
    if (qp < S)
      *reinterpret_cast<uint4*>(dq + base_q + qp * rsq + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<DQK>(row, ch));
  }
}

template <int DQK, int DV, int COL>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, const void* lse, void* delta, void* dq, int B,
                          int S, int T_len, int H, int G, const int64_t* st, float scale,
                          int causal, int q_off, cudaStream_t stream) {
  const size_t smem = dq_mma_smem_bytes<DQK, DV>();
  auto kernel = flash_bwd_dq_mma_kernel<DQK, DV, COL>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), S,
      T_len, H, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, q_off);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, void* delta, void* dq, int B,
                      int S, int T_len, int H, int G, const int64_t* st, float scale,
                      int causal, int q_off, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<DQK, DV>() * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, DQK, DV>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq), S,
      T_len, H, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, q_off);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B,
                       int S, int T_len, int H, int KH, const int64_t* st, float scale,
                       int causal, int q_off, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<DQK, DV>() * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, DQK, DV>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kBK - 1) / kBK, B * KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, T_len,
      H, KH, H / KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, q_off);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int T_len, int H, int KH, int causal, int q_off) {
  return B <= 0 || S <= 0 || T_len <= 0 || KH <= 0 || H % KH != 0 ||
         static_cast<long long>(B) * H > 65535 || q_off < 0 || (causal && q_off + S > T_len);
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// q [B,S,H,D], k [B,T,KH,D], v [B,T,KH,Dv] by the strides given (last dim
// contiguous); out, dout [B,S,H,Dv], dq [B,S,H,D] and lse, delta [B,H,S] f32
// contiguous; (D, Dv) one of (64, 64), (128, 128), (192, 128); q_off >= 0,
// and under causal q_off + S <= T (else cudaErrorInvalidValue).  Writes dq
// and delta = rowsum(dout * out).  bf16 goes to the tensor-core body
// (16-byte aligned q/k/v/out/dout, strides multiples of 8; the wrapper
// checks), f32 to the scalar body.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* delta, void* dq, int dtype, int B, int S,
                                      int T_len, int H, int KH, int D, int Dv, long long sqb,
                                      long long sqs, long long sqh, long long skb,
                                      long long skt, long long skh, long long svb,
                                      long long svt, long long svh, float scale,
                                      int causal, int q_off, void* stream) {
  if (bad_shape(B, S, T_len, H, KH, causal, q_off)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DQ_ARGS \
  q, k, v, out, dout, lse, delta, dq, B, S, T_len, H, G, st, scale, causal, q_off, s
  if (D == 64 && Dv == 64)
    return dtype == kFloat32 ? launch_dq<float, 64, 64>(REPRO_DQ_ARGS)
                             : launch_dq_mma<64, 64, 0>(REPRO_DQ_ARGS);
  if (D == 128 && Dv == 128)
    return dtype == kFloat32 ? launch_dq<float, 128, 128>(REPRO_DQ_ARGS)
                             : launch_dq_mma<128, 128, 0>(REPRO_DQ_ARGS);
  if (D == 192 && Dv == 128) {
    if (dtype == kFloat32) return launch_dq<float, 192, 128>(REPRO_DQ_ARGS);
    const cudaError_t err = launch_dq_mma<192, 128, 0>(REPRO_DQ_ARGS);  // dQ columns 0-95
    if (err != cudaSuccess) return err;
    return launch_dq_mma<192, 128, 1>(REPRO_DQ_ARGS);  // dQ columns 96-191
  }
#undef REPRO_DQ_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Same inputs (delta from flash_attention_bwd_dq); dk [B,T,KH,D] and dv
// [B,T,KH,Dv] contiguous, each summed over the G query heads of its kv head.
// bf16 goes to the tensor-core body (16-byte aligned q/k/v/dout, strides
// multiples of 8; the wrapper checks), run once for both results, or at
// (192, 128) as a dV pass then a dK pass on the same stream; f32 to the
// scalar body.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B, int S,
                                       int T_len, int H, int KH, int D, int Dv, long long sqb,
                                       long long sqs, long long sqh, long long skb,
                                       long long skt, long long skh, long long svb,
                                       long long svt, long long svh, float scale,
                                       int causal, int q_off, void* stream) {
  if (bad_shape(B, S, T_len, H, KH, causal, q_off)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DKV_ARGS \
  q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H, KH, st, scale, causal, q_off, s
  if (D == 64 && Dv == 64)
    return dtype == kFloat32 ? launch_dkv<float, 64, 64>(REPRO_DKV_ARGS)
                             : launch_dkv_mma<64, 64, kPartDV | kPartDK>(REPRO_DKV_ARGS);
  if (D == 128 && Dv == 128)
    return dtype == kFloat32 ? launch_dkv<float, 128, 128>(REPRO_DKV_ARGS)
                             : launch_dkv_mma<128, 128, kPartDV | kPartDK>(REPRO_DKV_ARGS);
  if (D == 192 && Dv == 128) {
    if (dtype == kFloat32) return launch_dkv<float, 192, 128>(REPRO_DKV_ARGS);
    const cudaError_t err = launch_dkv_mma<192, 128, kPartDV>(REPRO_DKV_ARGS);
    if (err != cudaSuccess) return err;
    return launch_dkv_mma<192, 128, kPartDK>(REPRO_DKV_ARGS);
  }
#undef REPRO_DKV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
