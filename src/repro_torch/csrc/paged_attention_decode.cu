// Paged-attention decode for Hopper (sm_90a): one query token per sequence,
// K/V read through a block table from a shared page pool.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`, launched by
// `paged_attention_decode` in src/repro/kernels/paged_attention.py.  Same
// function: positions >= length are masked (lengths clamped to M * P),
// block-table entries at or past ceil(len / P) are never read, nor the pages
// they name, and a length-0 row (an idle decode slot) gives exact zeros.
//
// What bounds it on this card: bytes, and at serving sizes the latency of a
// few dependent memory round trips.  Each (sequence, kv head) pair reads
// len x D keys and values once and does 4 G flops per key element (about
// 2 flop per byte in bf16 at G = 8, far below the ~295 flop/byte ridge).
// At B = 8 and len ~ 650 the floor is ~5 MB at 3.35 TB/s, ~1.6 us, less
// than two kernel launches.
//
// What this design does about it (flash-decoding):
//
//   * Split-KV.  The TPU walks a sequence's pages in order on one core; here
//     the grid is (n_splits, B * KH), split s covering positions
//     [s * kSplitSpan, (s + 1) * kSplitSpan) of one (sequence, kv head).
//     n_splits = ceil(M * P / kSplitSpan) comes from the shapes alone, so the
//     host never reads `lengths`; a split that starts at or past its length
//     exits before reading any table entry.  At B = 8, KH = 4 and ~650
//     positions a row that is ~340 working blocks, where one block per
//     (sequence, kv head) would be 32 on 132 SMs.
//   * 16-byte loads, once for all G heads.  Each thread looks up the page of
//     its positions and loads 16 bytes of each K and V row straight into
//     registers (a bf16 row of D = 64 is 8 lanes, so one warp-wide load
//     covers 4 positions), all of a split's loads issued before any is used.
//     The thread's 16 bytes of q for 8 heads at a time sit in registers too:
//     it forms its chunk's partial dot for each head, and the lanes of a row
//     sum them by halving exchanges (7 shuffles for 8 heads over 8 lanes,
//     where summing each whole would take 24), each lane ending on one
//     head's score.  Shared memory holds only the scores and the per-warp
//     P V sums, so the loops read no operand from it.
//   * f32 softmax per head over the split, one warp per head; P V from the
//     V chunks in registers, summed over a warp's rows by the same halving
//     exchanges and over the block's warps in order.  The split's max m,
//     sum l and unnormalised acc = sum_t e^(s_t - m) v_t go to an f32
//     workspace the wrapper allocates.
//   * A fixed-order merge.  `paged_decode_merge_kernel`, one block per
//     (sequence, kv head, query head), takes the active splits: m = max m_s,
//     l = sum e^(m_s - m) l_s, acc likewise in a fixed order, out = acc /
//     max(l, 1e-30).  No atomics, so two launches give the same bits.  It is
//     launched as a programmatic dependent of the split kernel, so its blocks
//     start while the split's last blocks run and wait in
//     `griddepcontrol.wait` for the partials (about 1 us less per call at
//     the serving shape than a plain second launch).
//
// At the serving shape the two kernels take ~10 and ~3.5 us of device time
// (PERF.md section 6): three dependent memory round trips (length, table
// entry, K/V row) and the merge's, not bandwidth, set the pace.  At 126
// registers a thread (bf16, D = 64) an SM holds 4 split blocks, so B = 8 at
// 2048 positions (1024 blocks) runs in two waves.
//
// The f32 instantiations use the same bodies with 16-byte loads of 4 floats.
// Block tables and lengths are read as int64 (the server's type) or int32,
// by a code passed in, so the wrapper casts nothing.
//
// Narrow heads (D 16 and 32, the reduced configs' rows of 32-128 bytes) have
// too few 16-byte lanes a row for that tiling: `paged_decode_narrow_kernel`
// is a plain body for them, one thread per position of the split (its K
// and V rows loaded element by element into registers and shared memory),
// the same softmax per head, and P V summed over the split's positions in
// order by one thread per output element.  It writes the same partials, so
// the same merge follows.

#include <math.h>

#include <atomic>

#include "common.cuh"

namespace reprotorch {
namespace {

constexpr int kSplitSpan = 64;  // positions per split (any P: pages may straddle splits)
constexpr int kSplitIters = 4;  // 16-byte chunks of K, and of V, per thread
constexpr int kHeadGroup = 8;   // query heads held in registers at once
constexpr int kMergeThreads = 128;

enum IndexType : int { kInt32 = 0, kInt64 = 1 };

// How a split's 16-byte loads tile it: lanes of one position's row, rows per
// warp and per pass of the block, and the block's threads, so that each
// thread holds kSplitIters chunks of K and of V whatever the row's width
// (128 threads for bf16 at D = 64, 512 for f32 at D = 128).
template <typename T, int D>
struct SplitShape {
  static constexpr int kVec = vec16<T>();  // elements per 16-byte chunk
  static constexpr int kLanesPerRow = D / kVec;
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  static constexpr int kRowsPerPass = kSplitSpan / kSplitIters;
  static constexpr int kThreads = kRowsPerPass * kLanesPerRow;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kIters = kSplitIters;
  // P V sums a lane keeps once the rows of its warp are summed
  static constexpr int kKept = kHeadGroup * kVec / kRowsPerWarp;
  static_assert(kLanesPerRow >= kHeadGroup && kLanesPerRow <= 32 &&
                    kSplitSpan % kRowsPerPass == 0 && kHeadGroup % kRowsPerWarp == 0,
                "split tiling");
};

__device__ __forceinline__ int64_t load_index(const void* p, int64_t i, int index_type) {
  return index_type == kInt64 ? static_cast<const long long*>(p)[i]
                              : static_cast<const int*>(p)[i];
}

// lengths[b] clamped to [0, M * P]
__device__ __forceinline__ int row_length(const void* lengths, int b, int index_type,
                                          int max_len) {
  const int64_t n = load_index(lengths, b, index_type);
  return static_cast<int>(n < 0 ? 0 : (n > max_len ? max_len : n));
}

// The 16 bytes of `u` as f32 (8 bf16 or 4 f32).
template <typename T>
__device__ __forceinline__ void unpack16(float* f, const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  }
}

// Sums each of v[0..N) over the lanes that differ only in lane bits O, O/2,
// ..., LO.  While a lane holds more than one value, each offset halves them
// (the lane whose bit is set keeps the upper half), so a warp needs N - 1
// shuffles where summing each value whole would take N log2(O / LO * 2).
// Afterwards v[0 .. max(N >> k, 1)) holds the sums of the values from
// index sum_i bit_i * N / 2^(i+1) on, bit_i the lane's bit at the i-th of
// the k halving offsets.
template <int N, int O, int LO>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (N > 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
  }
  if constexpr (O > LO) reduce_scatter<(N > 1 ? N / 2 : 1), O / 2, LO>(v, lane);
}

template <typename T, int D>
size_t split_smem_bytes(int G) {
  return sizeof(float) * (static_cast<size_t>(G) * kSplitSpan             // scores, then e^(s - m)
                          + SplitShape<T, D>::kWarps * kHeadGroup * D);  // P V of each warp
}

// One split of one (sequence, kv head): its (m, l, acc) for the G heads.
template <typename T, int D>
__global__ void __launch_bounds__(SplitShape<T, D>::kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const void* __restrict__ tables,
                          const void* __restrict__ lengths, int index_type,
                          float* __restrict__ part_acc, float* __restrict__ part_ml, int KH,
                          int G, int P, int M, int n_splits, float scale) {
  using S = SplitShape<T, D>;
  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;                   // [G][kSplitSpan]
  float* Rs = Ss + G * kSplitSpan;    // [S::kWarps][kHeadGroup][D]

  const int split = blockIdx.x, bkh = blockIdx.y;
  const int b = bkh / KH, kh = bkh % KH;
  const int len = row_length(lengths, b, index_type, M * P);
  const int start = split * kSplitSpan;
  if (start >= len) return;  // no work: no table entry or page is read

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int chunk = tid % S::kLanesPerRow;  // this thread's 16 bytes of a row
  const int row = tid / S::kLanesPerRow;    // its position within a pass
  const int64_t tok = static_cast<int64_t>(KH) * D;  // one position of a page
  const int64_t col = static_cast<int64_t>(kh) * D + chunk * S::kVec;
  const int64_t table_row = static_cast<int64_t>(b) * M;

  // every K and V load of the split in flight before any is used; rows at or
  // past len stay zero
  uint4 kreg[S::kIters], vreg[S::kIters];
#pragma unroll
  for (int it = 0; it < S::kIters; ++it) {
    const int t = start + it * S::kRowsPerPass + row;
    kreg[it] = vreg[it] = make_uint4(0, 0, 0, 0);
    if (t < len) {
      const int64_t page = load_index(tables, table_row + t / P, index_type);
      const int64_t off = (page * P + t % P) * tok + col;
      kreg[it] = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
      vreg[it] = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
    }
  }

  // scores of up to kHeadGroup heads at a time, q (pre-scaled) in registers:
  // each thread's partial dots over its chunk, summed over the row's lanes
  const T* qb = q + static_cast<int64_t>(bkh) * G * D + chunk * S::kVec;
  constexpr int kLanesPerHead = S::kLanesPerRow / kHeadGroup;
  for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
    float qr[kHeadGroup][S::kVec];
#pragma unroll
    for (int j = 0; j < kHeadGroup; ++j) {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (g0 + j < G) u = __ldg(reinterpret_cast<const uint4*>(qb + (g0 + j) * D));
      unpack16<T>(qr[j], u);
#pragma unroll
      for (int e = 0; e < S::kVec; ++e) qr[j][e] *= scale;
    }
    const int h = g0 + chunk / kLanesPerHead;  // the head this lane's sum ends on
#pragma unroll
    for (int it = 0; it < S::kIters; ++it) {
      float kf[S::kVec], sc[kHeadGroup];
      unpack16<T>(kf, kreg[it]);
#pragma unroll
      for (int j = 0; j < kHeadGroup; ++j) {
        sc[j] = 0.f;
#pragma unroll
        for (int e = 0; e < S::kVec; ++e) sc[j] = fmaf(qr[j][e], kf[e], sc[j]);
      }
      reduce_scatter<kHeadGroup, S::kLanesPerRow / 2, 1>(sc, lane);
      const int idx = it * S::kRowsPerPass + row;
      if (chunk % kLanesPerHead == 0 && h < G)
        Ss[h * kSplitSpan + idx] = start + idx < len ? sc[0] : -INFINITY;
    }
  }
  __syncthreads();

  // softmax over the split, one warp per head: (m, l) out, e^(s - m) back in Ss
  const int64_t part0 = (static_cast<int64_t>(bkh) * n_splits + split) * G;
  for (int g = warp; g < G; g += S::kWarps) {
    float* srow = Ss + g * kSplitSpan;
    float sv[kSplitSpan / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSplitSpan / 32; ++j) {
      sv[j] = srow[lane + 32 * j];
      mx = fmaxf(mx, sv[j]);
    }
    mx = warp_max(mx);  // finite: the split holds at least one position < len
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSplitSpan / 32; ++j) {
      const float p = __expf(sv[j] - mx);  // 0 past len
      srow[lane + 32 * j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_ml[2 * (part0 + g)] = mx;
      part_ml[2 * (part0 + g) + 1] = sum;
    }
  }
  __syncthreads();

  // P V of up to kHeadGroup heads at a time from the V chunks in registers:
  // summed over the rows of a warp by shuffles, then over the warps in order
  const int wrow = lane / S::kLanesPerRow;  // row within the warp
  for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
    float acc[kHeadGroup * S::kVec] = {};
#pragma unroll
    for (int it = 0; it < S::kIters; ++it) {
      const int idx = it * S::kRowsPerPass + row;
      float vf[S::kVec];
      unpack16<T>(vf, vreg[it]);
#pragma unroll
      for (int j = 0; j < kHeadGroup; ++j) {
        const float p = g0 + j < G ? Ss[(g0 + j) * kSplitSpan + idx] : 0.f;
#pragma unroll
        for (int e = 0; e < S::kVec; ++e)
          acc[j * S::kVec + e] = fmaf(p, vf[e], acc[j * S::kVec + e]);
      }
    }
    if constexpr (S::kRowsPerWarp > 1)
      reduce_scatter<kHeadGroup * S::kVec, 16, S::kLanesPerRow>(acc, lane);
    // this lane now holds heads [wrow * kKept / kVec, ...) of its chunk
    float* red = Rs + warp * kHeadGroup * D + chunk * S::kVec;
#pragma unroll
    for (int i = 0; i < S::kKept; i += 4) {
      const int f = wrow * S::kKept + i;  // flattened (head, element) index
      *reinterpret_cast<float4*>(red + (f / S::kVec) * D + f % S::kVec) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
    __syncthreads();
    for (int o = 4 * tid; o < kHeadGroup * D; o += 4 * S::kThreads) {
      if (g0 + o / D >= G) break;
      float4 a = *reinterpret_cast<const float4*>(Rs + o);
#pragma unroll
      for (int w = 1; w < S::kWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(Rs + w * kHeadGroup * D + o);
        a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      }
      *reinterpret_cast<float4*>(part_acc + (part0 + g0) * D + o) = a;
    }
    __syncthreads();  // Rs is taken again by the next group
  }
}

template <int D>
size_t narrow_smem_bytes(int G) {
  return sizeof(float) * (static_cast<size_t>(G) * kSplitSpan  // scores, then e^(s - m)
                          + kSplitSpan * D                      // the split's V rows
                          + static_cast<size_t>(G) * D);        // q, pre-scaled
}

// One split of one (sequence, kv head) at a narrow head dim: its (m, l, acc)
// for the G heads, as `paged_decode_split_kernel` writes them.
template <typename T, int D>
__global__ void __launch_bounds__(kSplitSpan)
paged_decode_narrow_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages, const void* __restrict__ tables,
                           const void* __restrict__ lengths, int index_type,
                           float* __restrict__ part_acc, float* __restrict__ part_ml, int KH,
                           int G, int P, int M, int n_splits, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;                  // [G][kSplitSpan]
  float* Vs = Ss + G * kSplitSpan;   // [kSplitSpan][D]
  float* Qs = Vs + kSplitSpan * D;   // [G][D]

  const int split = blockIdx.x, bkh = blockIdx.y;
  const int b = bkh / KH, kh = bkh % KH;
  const int len = row_length(lengths, b, index_type, M * P);
  const int start = split * kSplitSpan;
  if (start >= len) return;  // no work: no table entry or page is read

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* qb = q + static_cast<int64_t>(bkh) * G * D;
  for (int i = tid; i < G * D; i += kSplitSpan) Qs[i] = to_f32(qb[i]) * scale;

  // this thread's position: its K row in registers, its V row in Vs (zeros
  // past len)
  const int t = start + tid;
  float kf[D];
#pragma unroll
  for (int d = 0; d < D; ++d) kf[d] = 0.f;
  float* vrow = Vs + tid * D;
  if (t < len) {
    const int64_t page = load_index(tables, static_cast<int64_t>(b) * M + t / P, index_type);
    const int64_t off = ((page * P + t % P) * KH + kh) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kf[d] = to_f32(k_pages[off + d]);
      vrow[d] = to_f32(v_pages[off + d]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) vrow[d] = 0.f;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float sc = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) sc = fmaf(Qs[g * D + d], kf[d], sc);
    Ss[g * kSplitSpan + tid] = t < len ? sc : -INFINITY;
  }
  __syncthreads();

  // softmax over the split, one warp per head: (m, l) out, e^(s - m) back in Ss
  const int64_t part0 = (static_cast<int64_t>(bkh) * n_splits + split) * G;
  for (int g = warp; g < G; g += kSplitSpan / 32) {
    float* srow = Ss + g * kSplitSpan;
    float sv[kSplitSpan / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSplitSpan / 32; ++j) {
      sv[j] = srow[lane + 32 * j];
      mx = fmaxf(mx, sv[j]);
    }
    mx = warp_max(mx);  // finite: the split holds at least one position < len
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSplitSpan / 32; ++j) {
      const float p = __expf(sv[j] - mx);  // 0 past len
      srow[lane + 32 * j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_ml[2 * (part0 + g)] = mx;
      part_ml[2 * (part0 + g) + 1] = sum;
    }
  }
  __syncthreads();

  // P V: one thread per (head, element), the split's positions in order
  for (int o = tid; o < G * D; o += kSplitSpan) {
    const int g = o / D, d = o % D;
    const float* prow = Ss + g * kSplitSpan;
    float acc = 0.f;
    for (int j = 0; j < kSplitSpan; ++j) acc = fmaf(prow[j], Vs[j * D + d], acc);
    part_acc[(part0 + g) * D + d] = acc;
  }
}

// The splits of one (sequence, kv head) for one query head, merged in a
// fixed order: group j of the block's threads sums splits j, j + groups,
// ... in order, and the groups' sums are added in order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const void* __restrict__ lengths, int index_type, T* __restrict__ out,
                          int KH, int G, int D, int P, int M, int n_splits) {
  extern __shared__ __align__(16) float wsm[];
  const int quads = D / 4, groups = kMergeThreads / quads;
  float* Acc = wsm;                   // [groups][D]
  float& l_all = wsm[groups * D];     // max(l, 1e-30)
  float* W = wsm + groups * D + 1;    // [n_splits]: e^(m_s - m)
  const int g = blockIdx.x, bkh = blockIdx.y;
  const int len = row_length(lengths, bkh / KH, index_type, M * P);
  const int n_act = (len + kSplitSpan - 1) / kSplitSpan;  // 0 for an idle row
  const int tid = threadIdx.x, lane = tid % 32;
  const int64_t part0 = static_cast<int64_t>(bkh) * n_splits * G + g;  // split s: + s * G
  // launched early (programmatic dependent launch): wait here until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (tid < 32) {
    float mx = -INFINITY;
    for (int s = lane; s < n_act; s += 32) mx = fmaxf(mx, part_ml[2 * (part0 + s * G)]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < n_act; s += 32) {
      const float w = __expf(part_ml[2 * (part0 + s * G)] - mx);
      W[s] = w;
      l = fmaf(w, part_ml[2 * (part0 + s * G) + 1], l);
    }
    l = warp_sum(l);
    if (lane == 0) l_all = fmaxf(l, 1e-30f);
  }
  __syncthreads();

  const int qd = tid % quads, grp = tid / quads;  // kMergeThreads % quads == 0 (D 16 .. 128)
  const float* src = part_acc + part0 * D + 4 * qd;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < n_act; s += groups) {
    const float w = W[s];
    const float4 x = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(s) * G * D);
    a.x = fmaf(w, x.x, a.x);
    a.y = fmaf(w, x.y, a.y);
    a.z = fmaf(w, x.z, a.z);
    a.w = fmaf(w, x.w, a.w);
  }
  *reinterpret_cast<float4*>(Acc + grp * D + 4 * qd) = a;
  __syncthreads();
  if (tid < quads) {
    float4 sum = *reinterpret_cast<const float4*>(Acc + 4 * tid);
    for (int j = 1; j < groups; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(Acc + j * D + 4 * tid);
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
    T* ob = out + (static_cast<int64_t>(bkh) * G + g) * D + 4 * tid;
    ob[0] = from_f32<T>(sum.x / l_all);
    ob[1] = from_f32<T>(sum.y / l_all);
    ob[2] = from_f32<T>(sum.z / l_all);
    ob[3] = from_f32<T>(sum.w / l_all);
  }
}

// Opt `kernel` into the card's whole shared memory, once per device: `done`
// is the caller's record for one kernel, a bit per device.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = set_smem(kernel, kMaxSmemPerBlock);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Narrow head dims (D < 64) take `paged_decode_narrow_kernel`, the others the
// tiled split body; both are followed by the same merge.
template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* k_pages, const void* v_pages,
                         const void* tables, const void* lengths, int index_type,
                         float* part_acc, float* part_ml, void* out, int B, int KH, int G,
                         int P, int M, int n_splits, float scale, cudaStream_t stream) {
  using SplitFn = void (*)(const T*, const T*, const T*, const void*, const void*, int, float*,
                           float*, int, int, int, int, int, float);
  static std::atomic<uint64_t> split_ready{0}, merge_ready{0};
  SplitFn split_kernel;
  size_t split_smem;
  int split_threads;
  if constexpr (D < 64) {
    split_kernel = paged_decode_narrow_kernel<T, D>;
    split_smem = narrow_smem_bytes<D>(G);
    split_threads = kSplitSpan;
  } else {
    split_kernel = paged_decode_split_kernel<T, D>;
    split_smem = split_smem_bytes<T, D>(G);
    split_threads = SplitShape<T, D>::kThreads;
  }
  const size_t merge_smem = sizeof(float) * (static_cast<size_t>(kMergeThreads) * 4 + 1 + n_splits);
  if (split_smem > kMaxSmemPerBlock || merge_smem > kMaxSmemPerBlock)
    return cudaErrorInvalidValue;
  auto merge_kernel = paged_decode_merge_kernel<T>;
  cudaError_t err = allow_smem_once(split_kernel, split_ready);
  if (err == cudaSuccess) err = allow_smem_once(merge_kernel, merge_ready);
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(n_splits, B * KH), split_threads, split_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, lengths, index_type, part_acc, part_ml, KH, G,
      P, M, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge may start while the split kernel's last blocks run
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, B * KH);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* acc_in = part_acc;
  const float* ml_in = part_ml;
  T* out_t = static_cast<T*>(out);
  err = cudaLaunchKernelEx(&cfg, merge_kernel, acc_in, ml_in, lengths, index_type, out_t, KH, G,
                           D, P, M, n_splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace reprotorch

using namespace reprotorch;

// q [B,KH,G,D], pages [N,P,KH,D] (K and V, 16-byte aligned), out [B,KH,G,D],
// all contiguous; block_tables [B,M] and lengths [B] of one index type
// (index_type 0: int32, 1: int64).  part_acc [B*KH, n_splits, G, D] and
// part_ml [B*KH, n_splits, G, 2] are f32 workspace, n_splits =
// ceil(M * P / 64).  Returns the launches' cudaError_t.
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* block_tables,
                                      const void* lengths, int index_type, void* part_acc,
                                      void* part_ml, void* out, int dtype, int B, int KH,
                                      int G, int D, int P, int M, int n_splits, float scale,
                                      void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || P <= 0 || M <= 0 || B * KH > 65535 ||
      (index_type != kInt32 && index_type != kInt64) ||
      static_cast<int64_t>(n_splits) * kSplitSpan < static_cast<int64_t>(M) * P ||
      static_cast<int64_t>(n_splits - 1) * kSplitSpan >= static_cast<int64_t>(M) * P)
    return static_cast<int>(cudaErrorInvalidValue);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 16)
    return launch_paged<float, 16>(q, k_pages, v_pages, block_tables, lengths, index_type, acc,
                                   ml, out, B, KH, G, P, M, n_splits, scale, s);
  if (dtype == kFloat32 && D == 32)
    return launch_paged<float, 32>(q, k_pages, v_pages, block_tables, lengths, index_type, acc,
                                   ml, out, B, KH, G, P, M, n_splits, scale, s);
  if (dtype == kBFloat16 && D == 16)
    return launch_paged<__nv_bfloat16, 16>(q, k_pages, v_pages, block_tables, lengths,
                                           index_type, acc, ml, out, B, KH, G, P, M, n_splits,
                                           scale, s);
  if (dtype == kBFloat16 && D == 32)
    return launch_paged<__nv_bfloat16, 32>(q, k_pages, v_pages, block_tables, lengths,
                                           index_type, acc, ml, out, B, KH, G, P, M, n_splits,
                                           scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch_paged<float, 64>(q, k_pages, v_pages, block_tables, lengths, index_type, acc,
                                   ml, out, B, KH, G, P, M, n_splits, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_paged<float, 128>(q, k_pages, v_pages, block_tables, lengths, index_type,
                                    acc, ml, out, B, KH, G, P, M, n_splits, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_paged<__nv_bfloat16, 64>(q, k_pages, v_pages, block_tables, lengths,
                                           index_type, acc, ml, out, B, KH, G, P, M, n_splits,
                                           scale, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_paged<__nv_bfloat16, 128>(q, k_pages, v_pages, block_tables, lengths,
                                            index_type, acc, ml, out, B, KH, G, P, M, n_splits,
                                            scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
