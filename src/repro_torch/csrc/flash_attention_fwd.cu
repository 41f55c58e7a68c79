// Flash attention forward for Hopper (sm_90a): out and log-sum-exp.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by `_fwd_call` in
// src/repro/kernels/flash_attention.py.  Same function: an online softmax
// over key tiles with f32 (m, l, acc) state, causal tiles past the diagonal
// skipped, `out` in the input type and `lse` in f32.  The TPU's sequential
// k-block grid axis becomes a loop inside the block; GQA reads K/V head
// h / G in place (no broadcast copy), and the strides of the layer layout
// [B, S, H, D] are taken as given, so the caller makes no transposes.
//
// What bounds it on this card: operations.  Prefill attention at S = 1536,
// H = 32, D = 64 does ~9.7 GFLOP causal and moves ~13 MB, far above the
// H100's ~295 FLOP/byte ridge, so the floor is the tensor-core rate.
//
// The causal mask is aligned at a query offset: row r may read key j iff
// j <= q_off + r.  q_off 0 is the top-left mask of S == T; a
// context-parallel rank passes its chunk's first row, so its S rows of a
// longer sequence read the keys the whole sequence's rows would.  Key tiles
// past the last row's limit are skipped, and tiles wholly below it take no
// mask, at every offset.
//
// Head dims: every body is a template on the query/key head dim DQK and the
// value head dim DV, as the TPU kernel takes any Dqk and a separate Dv.  The
// entry point instantiates (64, 64), (128, 128) and MLA's (192, 128)
// (DeepSeek-V3: nope 128 + rope 64, v 128).  Q and K tiles are DQK wide, V
// tiles and the output DV wide; at DQK = 192 a row is 24 16-byte chunks,
// which `cp_async_tile` walks flat (they do not divide 128 threads).
//
// Two bodies, chosen by the entry point from the storage type:
//
//   * bf16: `flash_fwd_mma_kernel`, on the tensor cores.  One block of 4
//     warps per (batch, head, 64-row query tile); each warp owns 16 whole
//     query rows across every 64-key tile, so the softmax's row max and row
//     sum need only shuffles within a quad of lanes, and S, P and the
//     output never leave registers.  Q arrives once by cp.async; K and V
//     tiles are double-buffered in XOR-swizzled shared memory, tile j + 1 in
//     flight by cp.async while tile j is computed, with one __syncthreads
//     per tile.  S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in, f32
//     accumulate), with Q and K fragments from ldmatrix and V fragments
//     from ldmatrix.trans.  The softmax runs on the accumulator fragment in
//     exp2 (one MUFU instruction) with scale * log2(e) folded in, and P is
//     packed to bf16 A fragments in registers.  Only tiles that cross the
//     diagonal or the ragged end of T take the masking branch; causal
//     blocks run longest first.  The epilogue scales by 1 / l and stores
//     through shared memory in 16-byte rows.
//   * f32: `flash_fwd_kernel`, the first design, kept for f32 only:
//     scalar f32 FMAs from shared memory with a 4x4 register tile per
//     thread.  Tensor cores in f32 would mean TF32, which would break the
//     f32 parity the serving and training checks hold at 1e-4.
//
// Next step: wgmma fed by TMA with a producer warp (ROADMAP, Queue 2).

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace reprotorch {
namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 rows x 4 key cols

template <int DQK, int DV>
constexpr size_t flash_smem_floats() {
  return kBQ * (DQK + 1)    // Q tile (pre-scaled), padded rows
         + kBK * (DQK + 1)  // K tile, padded rows
         + kBK * DV         // V tile
         + kBQ * (kBK + 1)  // scores, then probabilities
         + 3 * kBQ;         // m, l, per-tile rescale factor
}

// f32 body: scalar FMAs on the CUDA cores (instantiated for f32 only).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_len, int H, int G,
                 int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                 int64_t skt, int64_t skh, int64_t svb, int64_t svt,
                 int64_t svh, float scale, int causal, int q_off) {
  constexpr int QP = DQK + 1;  // padded row pitch of Q and K
  constexpr int PP = kBK + 1;   // padded row pitch of the score tile
  constexpr int NJ = DV / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QP;
  float* Vs = Ks + kBK * QP;
  float* Ps = Vs + kBK * DV;
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

  for (int i = tid; i < kBQ * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK;
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

  // causal: no row of this tile attends a key past its last row (row r
  // reads keys 0..q_off + r)
  const int t_end = causal ? min(T_len, q_off + q0 + kBQ) : T_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V/P reads are finished
    for (int i = tid; i < kBK * DQK; i += kThreads) {
      const int c = i / DQK, d = i % DQK;
      const int kp = k0 + c;
      Ks[c * QP + d] = kp < T_len ? to_f32(kb[kp * skt + d]) : 0.f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int c = i / DV, d = i % DV;
      const int kp = k0 + c;
      Vs[c * DV + d] = kp < T_len ? to_f32(vb[kp * svt + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = kp < T_len && (!causal || kp <= q_off + q0 + r);
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
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * DV + tx + 16 * j];
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
    T* orow = out + ((static_cast<int64_t>(b) * S + qp) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    if (tx == 0) lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps
constexpr float kLn2 = 0.6931471805599453f;

template <int DQK, int DV>
constexpr size_t fwd_mma_smem_bytes() {
  return (kBQ * DQK + 2 * kBK * (DQK + DV)) * sizeof(bf16);  // Q, then K and V twice
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int T_len, int H, int G, int64_t sqb,
                     int64_t sqs, int64_t sqh, int64_t skb, int64_t skt, int64_t skh,
                     int64_t svb, int64_t svt, int64_t svh, float scale_log2, int causal,
                     int q_off) {
  constexpr int KS = DQK / 16;  // k-steps over the query/key head dim
  constexpr int ND = DV / 8;    // n-tiles of an output row block
  constexpr int NK = kBK / 8;   // n-tiles of a score row block
  constexpr int CH = DV / 8;    // 16-byte chunks per output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * DQK;      // two stages of [kBK, DQK]
  bf16* Vs = Ks + 2 * kBK * DQK;  // two stages of [kBK, DV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int q0 = qt * kBQ;
  const int row0 = q0 + 16 * warp;  // this warp's first query row

  const bf16* kb = k + b * skb + kh * skh;
  const bf16* vb = v + b * svb + kh * svh;
  // causal: no row of this tile attends a key past its last row (row r
  // reads keys 0..q_off + r)
  const int t_end = causal ? min(T_len, q_off + q0 + kBQ) : T_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;

  cp_async_tile<DQK, kBQ, kMmaThreads>(Qs, q + b * sqb + h * sqh + q0 * sqs, sqs, S - q0);
  cp_async_tile<DQK, kBK, kMmaThreads>(Ks, kb, skt, T_len);
  cp_async_tile<DV, kBK, kMmaThreads>(Vs, vb, svt, T_len);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  // rows g and g + 8 of this warp: running max (log2 units, scale folded
  // in) and this lane's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j (and Q) landed; every warp is done with tile j - 1
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

    // S = Q K^T, Q's A fragments from shared memory
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(Qs + swz<DQK>(16 * warp + (lane & 15), 2 * ks + (lane >> 4))));
#pragma unroll
      for (int kn = 0; kn < NK / 2; ++kn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(Kt + swz<DQK>(16 * kn + (lane & 7) + ((lane >> 4) << 3),
                                                2 * ks + ((lane >> 3) & 1))));
        mma_bf16(s[2 * kn], qa, bk[0], bk[1]);
        mma_bf16(s[2 * kn + 1], qa, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    if (k0 + kBK > T_len || (causal && k0 + kBK - 1 > q_off + row0)) {
      // only tiles that cross the diagonal or the end of T: a key at or
      // past klim of its row is masked
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        const int klim = (causal ? min(T_len, q_off + row + 1) : T_len) - k0 - 2 * c;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          if (8 * n >= klim) s[n][2 * r] = -INFINITY;
          if (8 * n + 1 >= klim) s[n][2 * r + 1] = -INFINITY;
        }
      }
    }

    // online softmax on the accumulator fragment
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float corr = exp2_approx(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s[n][2 * r] = exp2_approx(s[n][2 * r] - m_use);
        s[n][2 * r + 1] = exp2_approx(s[n][2 * r + 1] - m_use);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
    }

    // O += P V, P packed to bf16 A fragments, k-step over 16 keys
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(Vt + swz<DV>(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                     2 * dn + (lane >> 4))));
        mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // epilogue: 1 / l, staged in this warp's own rows of Qs (no other warp
  // reads them: a DV-wide output row r sits at the start of Q row r, whose
  // pitch is DQK), then 16-byte stores of whole rows
  const auto stage = [](int row, int chunk) { return row * (DQK - DV) + swz<DV>(row, chunk); };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(Qs + stage(row, d) + 2 * c) =
          pack_bf16(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    const int qp = q0 + row;
    if (c == 0 && qp < S)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f));
  }
  __syncwarp();
  for (int x = lane; x < 16 * CH; x += 32) {
    const int row = 16 * warp + x / CH, ch = x % CH;
    const int qp = q0 + row;
    if (qp < S)
      *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * S + qp) * H + h) * DV + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + stage(row, ch));
  }
}

template <int DQK, int DV>
cudaError_t launch_flash_mma(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int S, int T_len, int H, int G, const int64_t* st,
                             float scale, int causal, int q_off, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem_bytes<DQK, DV>();
  auto kernel = flash_fwd_mma_kernel<DQK, DV>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, T_len, H, G, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale * kLog2e, causal, q_off);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int S, int T_len, int H, int G,
                         const int64_t* st, float scale, int causal, int q_off,
                         cudaStream_t stream) {
  const size_t smem = flash_smem_floats<DQK, DV>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DQK, DV>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), S, T_len, H, G, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, q_off);
  return cudaGetLastError();
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// q [B,S,H,D], k [B,T,KH,D], v [B,T,KH,Dv] (last dim contiguous, other dims
// by the strides given, in elements); out [B,S,H,Dv] and lse [B,H,S] f32
// contiguous; (D, Dv) one of (64, 64), (128, 128), (192, 128); q_off >= 0,
// and under causal q_off + S <= T (else cudaErrorInvalidValue).  bf16 goes to
// the tensor-core body, which also needs 16-byte aligned q/k/v and strides
// that are multiples of 8 (the wrapper checks); f32 goes to the scalar body.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int dtype, int B, int S,
                                   int T_len, int H, int KH, int D, int Dv, long long sqb,
                                   long long sqs, long long sqh, long long skb,
                                   long long skt, long long skh, long long svb,
                                   long long svt, long long svh, float scale,
                                   int causal, int q_off, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || KH <= 0 || H % KH != 0 ||
      static_cast<long long>(B) * H > 65535 || q_off < 0 || (causal && q_off + S > T_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(DQK, DV)                                                                   \
  if (D == DQK && Dv == DV)                                                                  \
    return dtype == kFloat32                                                                 \
               ? launch_flash<float, DQK, DV>(q, k, v, out, lse, B, S, T_len, H, G, st, scale, \
                                              causal, q_off, s)                              \
               : launch_flash_mma<DQK, DV>(q, k, v, out, lse, B, S, T_len, H, G, st, scale,    \
                                           causal, q_off, s);
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  REPRO_FWD(64, 64)
  REPRO_FWD(128, 128)
  REPRO_FWD(192, 128)
#undef REPRO_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* reprotorch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
