// Flash-decode for Hopper, sm_90a: one query token against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (`decode_attention`, body `_decode_kernel`): q (B, 1, H, D) against
// caches (B, S, Hkv, D) with cache positions >= lengths[b] masked, online
// softmax in fp32, fp32 or bf16 storage.
//
// Design.  The TPU kernel walks the cache length as a sequential grid
// axis, one batch row per core.  On an H100 that would leave all but B of
// 132 SMs idle, so several blocks share the cache of one (KV head, batch
// row) and their online softmaxes are merged with the algebra the online
// softmax uses within one (weights exp(m_s - max m)).  A block keeps the
// `rep = H / Hkv` query heads of its GQA group together, so each K/V row
// is read from device memory once for the whole group, as the TPU
// kernel's (Hkv, rep, D) reshape does.  The mask constant is the TPU
// kernel's finite -0.7 * FLT_MAX and l is clamped at 1e-30, as there, so
// a row with no valid position gets 0, as from the TPU kernel.
//
// What bounds it on an H100.  A decode step reads each valid cache row
// once: 2 tensors * Hkv * D * bytes per row, e.g. 2.1 MB for B = 4 rows of
// 520 at D = 256 in bf16 -- under 1 us at 3.35 TB/s, less than a kernel
// launch.  So the device time is latency: the launch, one block's chain
// of dependent steps, and every hand-off between blocks.
//
// Two routes, chosen by dtype, head dim and group before the launch
// (never after a failure): `decode_attention_fwd`'s `route` argument is
// 0 (by shape), 1 (CUDA cores) or 2 (tensor cores), and it returns -1
// where a forced route cannot take the shape.
//
// Tensor-core route (bf16, D = 16, 32, 64, 128, 160 or 256, rep <= 16):
// `decode_tc_kernel`, one launch.  The C blocks of a thread-block
// cluster take one (KV head, batch row); the wrapper picks C in
// {1, 2, 4, 8, 16} (8, or 16 where 8
// ranks would loop over tiles, halved while the card cannot hold every
// cluster at once: cudaOccupancyMaxActiveClusters).  Each block reads
// lengths[b] on the device, clamps it to S, and takes its rank's share of
// the valid rows (`rank_rows`: the 16-row pieces dealt out evenly, so no
// block reads padding and at 520 valid rows and C = 8 none reads more
// than 80).  All 256 threads copy Q (issued before the length is read, so
// the two trips to memory overlap), then the rank's K rows, then its V
// rows, by 16-byte cp.async in two groups, so the scores run while V
// lands; rows are padded by 16 bytes so ldmatrix's row reads hit distinct
// banks.  (Bulk copies on an mbarrier, one a row, or one a tile into
// unpadded rows, whose ldmatrix reads then conflict 8-way, both measured
// slower on an H100.)  The products are those of the mma.sync kernel this
// one replaced: S = Q K^T on mma.sync m16n8k16 with the group's query
// heads as the 16 rows (rep < 16 pads with zero rows: free work in a
// latency-bound call), warp w taking the 8-key pieces w and w + 8; the
// row max and sum cross warps through a few floats of shared memory; P is
// rounded to bf16 into shared memory and is the A operand of O = P V,
// with V read by ldmatrix.trans and the warps splitting D.  wgmma's 64
// rows would be mostly padding.  A rank's range longer than its
// shared-memory tile (at most 128 rows: the model checks' 2048 and 4096
// slots) loops over tiles with the online softmax.  The merge goes
// through distributed shared memory in one hand-off: each rank pushes
// (st.shared::cluster) its acc at the D / C columns rank r merges into
// rank r's shared memory, and its m and l of every row to every rank;
// one cluster barrier (release / acquire); then rank r weighs the ranks
// in rank order (so the result does not depend on timing) by exp(m_s -
// max m) and writes its columns of the output from its own shared memory,
// so no block reads another's memory and none has to wait for its peers
// before it exits.  The first half of a barrier arrived at the start and
// waited on just before the first push makes sure every block of the
// cluster has started.  A rank with no rows pushes acc = 0, m =
// -0.7 FLT_MAX and l = 0, so its weight is 0.  No workspace, no second
// launch, no counter to zero.  Attributes (shared memory, the
// non-portable cluster size of 16) are set once per device; a refused
// cluster launch returns its cudaError_t.
//
// CUDA-core route (fp32, head dim 8, groups above 16, forced bf16):
// `decode_kernel`, one block per (split, KV head, batch row), each split
// kSplit = 64 cache rows long, so a block's chain is one tile; a split
// that starts at or past lengths[b] exits before loading anything.  Each
// live split writes its partial (acc, m, l) to a per-call workspace and
// `combine_kernel` merges them; with one split the split kernel writes
// the output itself.  fp32 stays off the tensor cores because TF32
// (~1e-3) misses its 2e-5 tolerance, head dim 8 because mma needs a depth
// of 16.  The route is bound like the other by latency: at fp32 a split
// moves 2 * 64 * D * 4 bytes (128 KB at D = 256) into one SM, and its
// arithmetic (4 * rep * 64 * D flops) is a few hundred cycles of one SM's
// FMAs, so what counts is the chain of one block: no serial tiles, no
// long chains of dependent FMAs, no idle warps:
//   * the split's whole K tile, then its V tile, are copied with 16-byte
//     cp.async in two commit groups, so the scores run while V lands;
//     rows past the split's valid length are not copied (their scores
//     are masked, and P V stops at the valid length).  Rows stay
//     unpadded in the storage type: every read below has a warp's lanes
//     on consecutive 16-byte chunks of consecutive rows, which hit
//     distinct banks without padding;
//   * all 8 warps compute scores: warp w takes keys 8w .. 8w + 7, the
//     lanes of one dot product split D in 16-byte chunks (the largest
//     power of two up to 32 that divides the D / VEC chunks, each lane
//     taking every such lane count-th chunk: 8 lanes of 5 chunks at
//     D = 160 in fp32, 4 in bf16; the other lanes of the warp take other
//     keys), the query rows of a block of kRows sit in registers against
//     each K chunk, and the partial sums meet by shuffles;
//   * one softmax over the split's 64 keys (no second tile, no rescale);
//   * P V: threads run along D in 16-byte chunks (a key group as many
//     lanes as a dot product, each lane its chunks one after the other)
//     and the key groups split the keys; partial sums meet by shuffles
//     within a warp, then across warps in shared memory laid over the K
//     tile, which is dead by then;
//   * groups above kRows rows loop over blocks of kRows query heads, so
//     registers do not grow with the group (groups 17..32 and more).
// Shared memory: 2 * 64 * D * sizeof(T) for K and V plus 4 * (rep * D +
// 64 * rep + 2 * rep) bytes: fp32 at D = 256 and a group of 4 takes 136 KB,
// one block per SM (the 132 SMs hold a decode call's 4 * 16 splits at
// once); bf16 there 71 KB, three a SM; lm-tiny's fp32 D = 16 group of 2
// takes 9.4 KB, six a SM (the CUDA occupancy calculator on an H100).
// What is left of a call at lm-tiny's shapes is one round trip to device
// memory and the chain of four barriers between copy, scores, softmax,
// P V and the partial sums.
//
// The combine (CUDA-core route only): one block per (row of the group, KV
// head, batch row), threads along D.  It reads each live split's m and l
// once into shared memory, computes each split's weight once, and sums
// the partials with independent 16-byte loads.  The tensor-core route
// folds this merge into its one launch through the cluster's distributed
// shared memory; before Hopper's clusters that needed a counter zeroed for
// every call (the last block of a (b, hk) to finish would combine), which
// is a launch of its own.

#include <atomic>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * FLT_MAX
constexpr int kSplit = 64;       // cache rows per split
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;         // CUDA-core: query heads per register block
constexpr int kTcRows = 16;      // mma rows: the group, zero-padded
constexpr int kTcMaxGroup = 16;
constexpr int kTcMaxTile = 128;  // rows a tensor-core rank holds at once
constexpr int kCombineThreads = 64;
constexpr int kMaxCombineSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16 bytes of T from shared memory, as fp32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    v[2 * u] = f.x;
    v[2 * u + 1] = f.y;
  }
}

bool tc_takes(int dtype, int D, int rep) {
  return dtype == 1 && rep >= 1 && rep <= kTcMaxGroup &&
         (D == 16 || D == 32 || D == 64 || D == 128 || D == 160 ||
          D == 256);
}

size_t smem_bytes(int rep, int D, size_t elem) {
  // k and v (64 x D, storage type); q (rep x D), p (rep rounded up to
  // kRows, x 64) and (m, l) of each row in fp32
  const size_t rp = (size_t)(rep + kRows - 1) / kRows * kRows;
  return elem * 2 * kSplit * D +
         sizeof(float) * ((size_t)rep * D + rp * kSplit + 2 * (size_t)rep);
}

// One block: split blockIdx.x of KV head blockIdx.y of batch row
// blockIdx.z.  With ws_acc == nullptr (one split) it writes the
// normalized output; otherwise the split's partial: acc (rep, D) and
// (m, l) for each of the rep rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, int S, int H, int Hkv,
              float scale) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int CH = D / VEC;             // chunks per row: 1 .. 64
  // lanes split a row's chunks by the largest power of two dividing CH:
  // CH itself where it is one, 8 of fp32's 40 and 4 of bf16's 20 at
  // D = 160, each lane then taking 5 chunks
  constexpr int P2 = CH & -CH;
  // scores: LPK lanes per dot product, GPW dot products per warp pass,
  // CPL chunks per lane
  constexpr int LPK = P2 < 32 ? P2 : 32;
  constexpr int GPW = 32 / LPK;
  constexpr int CPL = CH / LPK;
  // P V: KG key groups of PL threads, each thread PC chunks one after the
  // other; NP partials of each output left after the shuffles (one per
  // warp, or per key group when a group spans warps)
  constexpr int PL = P2;
  constexpr int PC = CH / PL;
  constexpr int KG = kThreads / PL;
  constexpr int NP = PL < 32 ? kWarps : KG;
  static_assert(D % VEC == 0 && CH <= 64, "a row is 1 .. 64 chunks");
  // every chunk has its lanes (none is dropped), the lanes of a dot
  // product and of a key group meet by shuffles within a warp or fill
  // whole warps, and the key groups tile the block
  static_assert(CH % LPK == 0 && 32 % LPK == 0 && CH % PL == 0 &&
                    kThreads % PL == 0 && (32 % PL == 0 || PL % 32 == 0),
                "the lanes split the chunks evenly");
  static_assert(NP * kRows * D * sizeof(float) <= kSplit * D * sizeof(T),
                "P V's partial sums fit over the K tile");

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int rp = (rep + kRows - 1) / kRows * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);               // 64 x D
  T* vs = ks + kSplit * D;                              // 64 x D
  float* qs = reinterpret_cast<float*>(vs + kSplit * D);  // rep x D
  float* ps = qs + rep * D;                             // rp x 64
  float* ml = ps + rp * kSplit;                         // rep x (m, l)
  float* red = reinterpret_cast<float*>(smem_raw);      // NP x kRows x D

  const int start = split * kSplit;
  const int n = min(start + kSplit, min(lengths[b], S)) - start;
  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * D;
  if (n <= 0) {
    if (ws_acc == nullptr)              // one split and an empty row: 0
      for (int i = tid; i < rep * D; i += kThreads) o[q_off + i] = from_f32<T>(0.f);
    return;                             // the combine skips it
  }

  // K (group 0), then V (group 1): the n valid rows, 16 bytes a copy
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t base = ((size_t)b * S + start) * kv_stride + (size_t)hk * D;
  for (int i = tid; i < n * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    mma::cp_async16(ks + r * D + c * VEC, kc + base + r * kv_stride + c * VEC,
                    16);
  }
  mma::cp_async_commit();
  for (int i = tid; i < n * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    mma::cp_async16(vs + r * D + c * VEC, vc + base + r * kv_stride + c * VEC,
                    16);
  }
  mma::cp_async_commit();
  for (int i = tid; i < rep * D; i += kThreads) qs[i] = to_f32(q[q_off + i]);
  mma::cp_async_wait<1>();
  __syncthreads();                        // q and K have landed

  // scores: warp w takes keys 8w .. 8w + 7; group g of LPK lanes one key
  // a pass, lane lp its chunks lp, lp + LPK, ...
  {
    const int g = lane / LPK, lp = lane % LPK;
    for (int r0 = 0; r0 < rep; r0 += kRows) {
      float qv[kRows][CPL][VEC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          if (r0 + r < rep) {
            const float* src = qs + (r0 + r) * D + (lp + LPK * i) * VEC;
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(src + e);
              qv[r][i][e] = x4.x;
              qv[r][i][e + 1] = x4.y;
              qv[r][i][e + 2] = x4.z;
              qv[r][i][e + 3] = x4.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) qv[r][i][e] = 0.f;
          }
        }
      // a warp-uniform trip count: every lane reaches the shuffles
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += GPW) {
        const int jl = k0 + g;            // key within the warp's 8
        const int j = warp * 8 + (jl < 8 ? jl : 0);
        float kv[CPL][VEC];
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          load16(ks + j * D + (lp + LPK * i) * VEC, kv[i]);
        float dot[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dot[r] = 0.f;
#pragma unroll
          for (int i = 0; i < CPL; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[r] = fmaf(qv[r][i][e], kv[i][e], dot[r]);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        }
        if (lp == 0 && jl < 8) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r0 + r < rep)   // rows past n hold stale data: masked
              ps[(r0 + r) * kSplit + j] = j < n ? dot[r] * scale : kNegInf;
        }
      }
    }
  }
  __syncthreads();

  // one softmax per row over the split's 64 keys, two keys a lane; the
  // rows that pad the last block of kRows get p = 0
  for (int r = warp; r < rp; r += kWarps) {
    float* prow = ps + r * kSplit;
    if (r >= rep) {
      prow[lane] = 0.f;
      prow[lane + 32] = 0.f;
      continue;
    }
    const float s0 = prow[lane], s1 = prow[lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = expf(s0 - m), p1 = expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    prow[lane] = p0;
    prow[lane + 32] = p1;
    if (lane == 0) {
      ml[2 * r] = m;
      ml[2 * r + 1] = l;
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();                        // V, p, m and l

  // O = P V: thread (key group kg, lane lp) over keys kg, kg + KG, ...
  // and chunks lp, lp + PL, ...
  const int lp = tid % PL, kg = tid / PL;
  const size_t part = (size_t)(b * Hkv + hk) * gridDim.x + split;
  for (int r0 = 0; r0 < rep; r0 += kRows) {
#pragma unroll
    for (int i = 0; i < PC; ++i) {
      const int c = lp + PL * i;
      float acc[kRows][VEC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
      for (int j = kg; j < n; j += KG) {
        float v[VEC];
        load16(vs + j * D + c * VEC, v);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = ps[(r0 + r) * kSplit + j];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, v[e], acc[r][e]);
        }
      }
      if constexpr (PL < 32) {            // key groups within a warp
#pragma unroll
        for (int off = PL; off < 32; off <<= 1)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
      }
      if (i == 0) __syncthreads();        // the last block's sums are read
      if (PL >= 32 || lane < PL) {
        const int pi = PL < 32 ? warp : kg;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(red + (pi * kRows + r) * D + c * VEC +
                                       e) =
                make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                            acc[r][e + 3]);
      }
    }
    __syncthreads();
    // the NP partials of each output, one float4 a thread
    for (int i = tid; i < kRows * D / 4; i += kThreads) {
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      const int row = r0 + r;
      if (row >= rep) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(red + (pp * kRows + r) * D + d);
        s.x += x4.x;
        s.y += x4.y;
        s.z += x4.z;
        s.w += x4.w;
      }
      if (ws_acc == nullptr) {
        const float inv = 1.f / fmaxf(ml[2 * row + 1], 1e-30f);
        T* orow = o + q_off + (size_t)row * D + d;
        orow[0] = from_f32<T>(s.x * inv);
        orow[1] = from_f32<T>(s.y * inv);
        orow[2] = from_f32<T>(s.z * inv);
        orow[3] = from_f32<T>(s.w * inv);
      } else {
        *reinterpret_cast<float4*>(ws_acc + (part * rep + row) * D + d) = s;
      }
    }
  }
  if (ws_acc != nullptr)
    for (int r = tid; r < rep; r += kThreads) {
      ws_ml[(part * rep + r) * 2] = ml[2 * r];
      ws_ml[(part * rep + r) * 2 + 1] = ml[2 * r + 1];
    }
}

// Tensor-core route (bf16): one launch, C blocks (a thread-block cluster)
// per (KV head, batch row).  Rank r of the cluster takes the cache rows
// rank_rows gives it, in tiles of at most `tile` rows; the cluster then
// merges the ranks' softmax states in distributed shared memory.

// The cache rows [lo, hi) of rank r when `len` rows are valid: the
// ceil(len / 16) 16-row pieces dealt out evenly in rank order, so no rank
// reads past the length and none holds more than ceil(pieces / C) pieces.
// (decode_attention.rank_rows mirrors it.)
__host__ __device__ inline void rank_rows(int len, int C, int r, int& lo,
                                          int& hi) {
  const int pieces = (len + 15) / 16;
  const int end = 16 * ((r + 1) * pieces / C);
  lo = 16 * (r * pieces / C);
  hi = end < len ? end : len;
}

// Rows a rank holds in shared memory at once: its most rows at S, at most
// kTcMaxTile (a longer range loops over tiles).
__host__ __device__ inline int tc_tile_rows(int S, int C) {
  const int per = ((S + 15) / 16 + C - 1) / C * 16;
  return per < kTcMaxTile ? per : kTcMaxTile;
}

// Byte offsets of the tensor-core kernel's shared memory: Q (16 rows), the
// K and V tiles, P (16 x tile), each warp's row max and row sum, and what
// the cluster's ranks push here: each rank's m and l of every row and its
// acc at this rank's D / C columns.  Rows of Q, K and V are padded by 16
// bytes so ldmatrix's eight row reads hit distinct banks.
struct TcSmem {
  int q, k, v, p, red_m, red_l, in_m, in_l, in_acc, total;
  __host__ __device__ TcSmem(int D, int tile, int C) {
    const int rs = (D + 8) * 2;
    q = 0;
    k = q + kTcRows * rs;
    v = k + tile * rs;
    p = v + tile * rs;
    red_m = p + kTcRows * (tile + 8) * 2;
    red_l = red_m + kWarps * kTcRows * 4;
    in_m = red_l + kWarps * kTcRows * 4;
    in_l = in_m + C * kTcRows * 4;
    in_acc = in_l + C * kTcRows * 4;
    total = in_acc + kTcRows * D * 4;     // C ranks x 16 rows x D / C
  }
};

template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                 const bf16* __restrict__ vc, const int* __restrict__ lengths,
                 bf16* __restrict__ o, int S, int H, int Hkv, int tile,
                 float scale) {
  constexpr int RS = D + 8;               // Q/K/V row stride (elements)
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr int NPAIR = D / 16;           // 16-column output slabs
  // slabs per warp; where they do not divide (10 slabs at D = 160) a
  // warp's last slab may be past NPAIR, and every use of it is skipped
  constexpr int PPW = (NPAIR + kWarps - 1) / kWarps;
  constexpr int DC = D / C;               // output columns a rank merges
  static_assert(DC >= 2 && DC % 2 == 0, "a rank merges column pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcSmem L(D, tile, C);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + L.v);
  bf16* ps = reinterpret_cast<bf16*>(smem_raw + L.p);
  float* red_m = reinterpret_cast<float*>(smem_raw + L.red_m);
  float* red_l = reinterpret_cast<float*>(smem_raw + L.red_l);
  float* in_m = reinterpret_cast<float*>(smem_raw + L.in_m);
  float* in_l = reinterpret_cast<float*>(smem_raw + L.in_l);
  float* in_acc = reinterpret_cast<float*>(smem_raw + L.in_acc);
  const int PS = tile + 8;                // P row stride

  // every block of the cluster has started before any writes to another's
  // shared memory: arrive now, wait just before the first such write
  hopper::cluster_arrive_relaxed();
  const int rank = (int)hopper::cluster_rank();
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* kb = kc + ((size_t)b * S * Hkv + hk) * D;
  const bf16* vb = vc + ((size_t)b * S * Hkv + hk) * D;

  // Q first (rows past the group zero-filled), so its trip to memory
  // overlaps the length's
  for (int i = tid; i < kTcRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < rep;
    mma::cp_async16(qs + r * RS + c * 8, q + q_off + (ok ? r * D + c * 8 : 0),
                    ok ? 16 : 0);
  }
  const int len = max(0, min(lengths[b], S));
  int lo, hi;
  rank_rows(len, C, rank, lo, hi);
  // rows [t0, t0 + n) by 16-byte cp.async: K (with Q) in one group, V in
  // the next, so the scores run while V lands; rows n .. 16 ceil(n / 16)
  // are zero-filled (P is 0 there, and 0 * V must not meet stale bits)
  auto issue = [&](int t0, int n) {
    const int n16 = (n + 15) / 16 * 16;
    for (int i = tid; i < n16 * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = r < n;
      mma::cp_async16(ks + r * RS + c * 8,
                      kb + (size_t)(t0 + (ok ? r : 0)) * kv_stride + c * 8,
                      ok ? 16 : 0);
    }
    mma::cp_async_commit();
    for (int i = tid; i < n16 * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = r < n;
      mma::cp_async16(vs + r * RS + c * 8,
                      vb + (size_t)(t0 + (ok ? r : 0)) * kv_stride + c * 8,
                      ok ? 16 : 0);
    }
    mma::cp_async_commit();
  };
  if (lo < hi) issue(lo, min(tile, hi - lo));
  mma::cp_async_commit();                 // Q alone, when the rank has no rows

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[PPW][2][4];
#pragma unroll
  for (int j = 0; j < PPW; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
  for (int t0 = lo; t0 < hi; t0 += tile) {
    const int n = min(tile, hi - t0);
    const int n16 = (n + 15) / 16;
    const int end = t0 + n;
    mma::cp_async_wait<2>();              // Q and K (an empty group follows)
    __syncthreads();

    // S = Q K^T: warp w takes the 8-key n-tiles w and w + 8; two
    // accumulators each halve the dependent mma chain
    float sa[2][2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sa[j][h][0] = sa[j][h][1] = sa[j][h][2] = sa[j][h][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_x4(a, qs + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = warp + 8 * j;
        if (nt < 2 * n16) {
          uint32_t bb[2];
          mma::ldsm_x2(bb, ks + (nt * 8 + lane % 8) * RS + kk * 16 +
                               ((lane / 8) % 2) * 8);
          mma::mma_bf16(sa[j][kk % 2], a, bb[0], bb[1]);
        }
      }
    }
    // this lane's scores: rows g (e = 0, 1) and g + 8 (e = 2, 3), keys
    // t0 + 8 nt + 2t + (e & 1)
    float s[2][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nt = warp + 8 * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nt * 8 + 2 * t + (e & 1);
        s[j][e] = nt < 2 * n16 && key < end
                      ? (sa[j][0][e] + sa[j][1][e]) * scale
                      : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t == 0) {
      red_m[warp * kTcRows + g] = mx[0];
      red_m[warp * kTcRows + g + 8] = mx[1];
    }
    __syncthreads();
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m_new[0] = fmaxf(m_new[0], red_m[w * kTcRows + g]);
      m_new[1] = fmaxf(m_new[1], red_m[w * kTcRows + g + 8]);
    }
    const float alpha[2] = {expf(m_run[0] - m_new[0]),
                            expf(m_run[1] - m_new[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nt = warp + 8 * j;
      if (nt < 2 * n16) {
        const float p0 = expf(s[j][0] - m_new[0]);
        const float p1 = expf(s[j][1] - m_new[0]);
        const float p2 = expf(s[j][2] - m_new[1]);
        const float p3 = expf(s[j][3] - m_new[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        *reinterpret_cast<uint32_t*>(ps + g * PS + nt * 8 + 2 * t) =
            mma::pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(ps + (g + 8) * PS + nt * 8 + 2 * t) =
            mma::pack_bf16(p2, p3);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
    if (t == 0) {
      red_l[warp * kTcRows + g] = rs[0];
      red_l[warp * kTcRows + g + 8] = rs[1];
    }
    mma::cp_async_wait<1>();              // V
    __syncthreads();                      // V, P and the row sums

    float l_tile[2] = {0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      l_tile[0] += red_l[w * kTcRows + g];
      l_tile[1] += red_l[w * kTcRows + g + 8];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + l_tile[r];
      m_run[r] = m_new[r];
    }
    // O = alpha O + P V: warp w takes the 16-column slabs w, w + 8, ...
#pragma unroll
    for (int j = 0; j < PPW; ++j)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        acc[j][nn][0] *= alpha[0];
        acc[j][nn][1] *= alpha[0];
        acc[j][nn][2] *= alpha[1];
        acc[j][nn][3] *= alpha[1];
      }
    for (int kk = 0; kk < n16; ++kk) {
      uint32_t pa[4];
      mma::ldsm_x4(pa, ps + (lane % 16) * PS + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < PPW; ++j) {
        const int slab = warp + j * kWarps;
        if (slab < NPAIR) {
          uint32_t bb[4];
          mma::ldsm_x4_t(bb, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      RS + slab * 16 + (lane / 16) * 8);
          mma::mma_bf16(acc[j][0], pa, bb[0], bb[1]);
          mma::mma_bf16(acc[j][1], pa, bb[2], bb[3]);
        }
      }
    }
    if (t0 + tile < hi) {
      __syncthreads();                    // every warp is done with the tile
      issue(t0 + tile, min(tile, hi - t0 - tile));
      mma::cp_async_commit();
    }
  }
  mma::cp_async_wait<0>();

  // push this rank's state to the rank that merges each column: its acc at
  // those columns, and to every rank its m and l; a rank with no rows
  // pushes acc = 0, m = -0.7 FLT_MAX, l = 0, so its weight below is 0
  hopper::cluster_wait();                 // every block has started
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    const int slab = warp + j * kWarps;
    if (slab >= NPAIR) continue;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int col = slab * 16 + nn * 8 + 2 * t;
      const int owner = col / DC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // rows g, g + 8
        const int r = g + 8 * h;
        if (r < rep)
          hopper::peer_store2(
              hopper::peer_addr(in_acc + (rank * kTcRows + r) * DC +
                                    col - owner * DC, owner),
              make_float2(acc[j][nn][2 * h], acc[j][nn][2 * h + 1]));
      }
    }
  }
  if (warp == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < rep)
        for (int dst = 0; dst < C; ++dst) {
          hopper::peer_store(
              hopper::peer_addr(in_m + rank * kTcRows + r, dst), m_run[h]);
          hopper::peer_store(
              hopper::peer_addr(in_l + rank * kTcRows + r, dst), l_run[h]);
        }
    }
  }
  hopper::cluster_sync();                 // every push has landed

  // this rank's columns [rank D / C, (rank + 1) D / C) of every row,
  // merged over the ranks in rank order with weights exp(m_s - max m);
  // nothing reads another block's memory from here on
  for (int i = tid; i < rep * (DC / 2); i += kThreads) {
    const int r = i / (DC / 2), c = 2 * (i % (DC / 2));
    float mm = kNegInf;
#pragma unroll
    for (int sr = 0; sr < C; ++sr) mm = fmaxf(mm, in_m[sr * kTcRows + r]);
    float l = 0.f, x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int sr = 0; sr < C; ++sr) {
      const float w = expf(in_m[sr * kTcRows + r] - mm);
      const float2 a = *reinterpret_cast<const float2*>(
          in_acc + (sr * kTcRows + r) * DC + c);
      l = fmaf(in_l[sr * kTcRows + r], w, l);
      x0 = fmaf(a.x, w, x0);
      x1 = fmaf(a.y, w, x1);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<uint32_t*>(o + q_off + r * D + rank * DC + c) =
        mma::pack_bf16(x0 * inv, x1 * inv);
  }
}

// Combine the live splits of one query head: row blockIdx.x of the group
// of KV head blockIdx.y, batch row blockIdx.z.  Dynamic shared memory:
// m (then the weights) and l of each split.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml,
               const int* __restrict__ lengths, T* __restrict__ o, int S,
               int H, int Hkv, int D, int n_split) {
  extern __shared__ float cs[];
  float* sw = cs;
  float* sl = cs + n_split;
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int len = min(lengths[b], S);
  const int n_live = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  const size_t part0 = (size_t)(b * Hkv + hk) * n_split;
  for (int s = tid; s < n_live; s += kCombineThreads) {
    const float* ml = ws_ml + ((part0 + s) * rep + r) * 2;
    sw[s] = ml[0];
    sl[s] = ml[1];
  }
  __syncthreads();
  float m = kNegInf;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, sw[s]);
  __syncthreads();                        // every m read before the weights
  for (int s = tid; s < n_live; s += kCombineThreads) sw[s] = expf(sw[s] - m);
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < n_live; ++s) l = fmaf(sl[s], sw[s], l);
  l = fmaxf(l, 1e-30f);
  const size_t stride = (size_t)rep * D;  // one split's partial
  const float* base = ws_acc + (part0 * rep + r) * D;
  T* orow = o + ((size_t)b * H + (size_t)hk * rep + r) * D;
  for (int c = 4 * tid; c < D; c += 4 * kCombineThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(base + s * stride + c);
      const float w = sw[s];
      acc.x = fmaf(x.x, w, acc.x);
      acc.y = fmaf(x.y, w, acc.y);
      acc.z = fmaf(x.z, w, acc.z);
      acc.w = fmaf(x.w, w, acc.w);
    }
    orow[c] = from_f32<T>(acc.x / l);
    orow[c + 1] = from_f32<T>(acc.y / l);
    orow[c + 2] = from_f32<T>(acc.z / l);
    orow[c + 3] = from_f32<T>(acc.w / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* ws_acc, float* ws_ml, int n_split, int B, int S,
           int H, int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D, sizeof(T));
  auto kernel = decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), ws_acc, ws_ml,
      S, H, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, void* o, float* wa, float* wm,
               int n_split, int B, int S, int H, int Hkv, float scale,
               cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 16: return launch<T, 16>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 32: return launch<T, 32>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 64: return launch<T, 64>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 128: return launch<T, 128>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 160: return launch<T, 160>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 256: return launch<T, 256>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    default: return -1;
  }
}

// The tensor-core kernel's attributes, set once per device: its largest
// shared memory and, for clusters of 16, the non-portable cluster size.
template <int D, int C>
cudaError_t tc_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_tc_kernel<D, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TcSmem(D, kTcMaxTile, C).total);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(decode_tc_kernel<D, C>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// The launch of C blocks a (KV head, batch row) as one cluster each.
template <int D, int C>
cudaLaunchConfig_t tc_config(int B, int S, int Hkv, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = TcSmem(D, tc_tile_rows(S, C), C).total;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, int C>
int launch_tc(const void* q, const void* k, const void* v, const int* lengths,
              void* o, int B, int S, int H, int Hkv, float scale,
              cudaStream_t stream) {
  cudaError_t e = tc_attributes<D, C>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tc_config<D, C>(B, S, Hkv, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, decode_tc_kernel<D, C>,
                         static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), lengths,
                         static_cast<bf16*>(o), S, H, Hkv,
                         tc_tile_rows(S, C), scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of the tensor-core kernel the card can hold at once at S, or a
// negated cudaError_t.
template <int D, int C>
int tc_max_clusters(int S) {
  cudaError_t e = tc_attributes<D, C>();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tc_config<D, C>(1, S, 1, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, decode_tc_kernel<D, C>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The tensor-core kernel at head dim D and cluster size C, where a rank
// merges at least a column pair (D / C >= 2); -1 elsewhere.
template <int D, int C>
int launch_tc_if(const void* q, const void* k, const void* v,
                 const int* lengths, void* o, int B, int S, int H, int Hkv,
                 float scale, cudaStream_t s) {
  if constexpr (D / C >= 2)
    return launch_tc<D, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
  return -1;
}

template <int C>
int dispatch_tc(int D, const void* q, const void* k, const void* v,
                const int* lengths, void* o, int B, int S, int H, int Hkv,
                float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc_if<16, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
    case 32: return launch_tc_if<32, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
    case 64: return launch_tc_if<64, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
    case 128: return launch_tc_if<128, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
    case 160: return launch_tc_if<160, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
    case 256: return launch_tc_if<256, C>(q, k, v, lengths, o, B, S, H, Hkv, scale, s);
    default: return -1;
  }
}

template <int D, int C>
int max_clusters_if(int S) {
  if constexpr (D / C >= 2) return tc_max_clusters<D, C>(S);
  return -1;
}

template <int C>
int dispatch_max_clusters(int D, int S) {
  switch (D) {
    case 16: return max_clusters_if<16, C>(S);
    case 32: return max_clusters_if<32, C>(S);
    case 64: return max_clusters_if<64, C>(S);
    case 128: return max_clusters_if<128, C>(S);
    case 160: return max_clusters_if<160, C>(S);
    case 256: return max_clusters_if<256, C>(S);
    default: return -1;
  }
}

// Either of the two above for a cluster size given at run time: 1, 2, 4,
// 8 or 16.
template <typename F>
int by_cluster(int cluster, F&& f) {
  switch (cluster) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return -1;
  }
}

template <typename T>
int launch_combine(const float* wa, const float* wm, const int* lengths,
                   void* o, int n_split, int B, int S, int H, int Hkv, int D,
                   cudaStream_t s) {
  combine_kernel<T><<<dim3(H / Hkv, Hkv, B), kCombineThreads,
                      2 * n_split * sizeof(float), s>>>(
      wa, wm, lengths, static_cast<T*>(o), S, H, Hkv, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory one block of `route` (1 CUDA cores, 2 tensor
// cores: its largest tile, at a cluster of 16) needs for dtype (0 fp32, 1
// bf16); the wrapper refuses a group that does not fit the card's 227 KB.
extern "C" long long decode_attention_smem_bytes(int rep, int D, int dtype,
                                                 int route) {
  return (long long)(route == 2 ? TcSmem(D, kTcMaxTile, 16).total
                                : smem_bytes(rep, D, dtype == 1 ? 2 : 4));
}

// Clusters of `cluster` (1, 2, 4, 8 or 16; at most D / 2) tensor-core
// blocks the card can hold at once at head dim D and S cache slots
// (cudaOccupancyMaxActiveClusters), or -1 / a negated cudaError_t.
extern "C" int decode_attention_max_active_clusters(int D, int S,
                                                    int cluster) {
  return by_cluster(cluster, [&](auto c) {
    return dispatch_max_clusters<decltype(c)::value>(D, S);
  });
}

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// shape / dtype / route this library has no kernel for.  dtype: 0 fp32,
// 1 bf16; route: 0 by shape, 1 CUDA cores, 2 tensor cores.  On the CUDA
// cores n_split must be ceil(S / 64) and ws hold B * Hkv * n_split * rep *
// (D + 2) floats (acc, then m and l; unused when n_split == 1).  On the
// tensor cores n_split is the cluster size (1, 2, 4, 8 or 16, at most
// D / 2) and ws is null: the one launch needs no workspace.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* ws, int n_split, int B,
                                    int S, int H, int Hkv, int D,
                                    float scale, int dtype, int route,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int rep = H / Hkv;
  if (route == 0) route = tc_takes(dtype, D, rep) ? 2 : 1;
  if (route == 2) {
    if (!tc_takes(dtype, D, rep) || ws != nullptr) return -1;
    return by_cluster(n_split, [&](auto c) {
      return dispatch_tc<decltype(c)::value>(D, q, k, v, len, o, B, S, H,
                                             Hkv, scale, s);
    });
  }
  if (route != 1 || n_split != (S + kSplit - 1) / kSplit ||
      2 * n_split * sizeof(float) > (size_t)kMaxCombineSmem)
    return -1;
  float* wa = n_split > 1 ? static_cast<float*>(ws) : nullptr;
  float* wm = wa ? wa + (size_t)B * Hkv * n_split * rep * D : nullptr;
  const int err = dtype == 0
      ? dispatch_d<float>(D, q, k, v, len, o, wa, wm, n_split, B, S, H, Hkv, scale, s)
      : dispatch_d<bf16>(D, q, k, v, len, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
  if (err != 0 || n_split == 1) return err;
  return dtype == 0
      ? launch_combine<float>(wa, wm, len, o, n_split, B, S, H, Hkv, D, s)
      : launch_combine<bf16>(wa, wm, len, o, n_split, B, S, H, Hkv, D, s);
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
