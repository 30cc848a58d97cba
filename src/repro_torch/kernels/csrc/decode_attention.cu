// Flash-decode for Hopper, sm_90a: one query token against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (`decode_attention`, body `_decode_kernel`): q (B, 1, H, D) against
// caches (B, S, Hkv, D) with cache positions >= lengths[b] masked, online
// softmax in fp32, fp32 or bf16 storage.
//
// Design, both routes.  The TPU kernel walks the cache length as a
// sequential grid axis, one batch row per core.  On an H100 that would
// leave all but B of 132 SMs idle, so the cache length is split
// (flash-decoding): one block per (split, KV head, batch row), each split
// kSplit = 64 cache rows long, so a block's chain is one tile.  A block
// keeps the `rep = H / Hkv` query heads of its GQA group together, so each
// K/V row is read from device memory once for the whole group, as the TPU
// kernel's (Hkv, rep, D) reshape does.  A split that starts at or past
// lengths[b] exits before loading anything.  Each live split writes its
// partial (acc, m, l) to a per-call workspace and `combine_kernel` merges
// them with the algebra the online softmax uses within one (weights
// exp(m_s - max m)); with one split the split kernel writes the output
// itself.  The mask constant is the TPU kernel's finite -0.7 * FLT_MAX
// and l is clamped at 1e-30, as there, so a row with no valid position
// gets 0, as from the TPU kernel.
//
// What bounds it on an H100.  A decode step reads each valid cache row
// once: 2 tensors * Hkv * D * bytes per row, e.g. 2.6 MB for B = 8 rows
// of mixed length (sum 5,149) at D = 256 in bf16 -- under 1 us at 3.35
// TB/s, less than a kernel launch.  So the device time is latency: one
// block's chain of dependent steps, plus the combine's.
//
// Two routes, chosen by dtype, head dim and group before the launch
// (never after a failure): `decode_attention_fwd`'s `route` argument is
// 0 (by shape), 1 (CUDA cores) or 2 (tensor cores), and it returns -1
// where a forced route cannot take the shape.
//
// Tensor-core route (bf16, D = 16..256, rep <= 16): `decode_tc_kernel`.
// The block issues 16-byte cp.async copies of Q, its K tile and its V tile at once (V in a second group,
// so the scores run while V lands); K and V stay bf16 in shared memory
// with rows padded by 16 bytes so ldmatrix's row reads hit distinct
// banks.  S = Q K^T runs on mma.sync m16n8k16 with the group's query
// heads as the 16 rows (rep < 16 pads with zero rows: free work in a
// latency-bound call); each of the 8 warps takes 8 keys, and the row max
// and sum cross warps through a few floats of shared memory.  P goes to
// shared memory as bf16 and is the A operand of O = P V, with V read by
// ldmatrix.trans and the warps splitting D.
//
// CUDA-core route (fp32, head dim 8, groups above 16, forced bf16):
// `decode_kernel`.  fp32 stays off the tensor cores because TF32 (~1e-3)
// misses its 2e-5 tolerance, head dim 8 because mma needs a depth of 16.
// The route is bound like the other by latency: at fp32 a split moves
// 2 * 64 * D * 4 bytes (128 KB at D = 256) into one SM, and its arithmetic
// (4 * rep * 64 * D flops) is a few hundred cycles of one SM's FMAs, so
// what counts is the chain of one block: no serial tiles, no long chains
// of dependent FMAs, no idle warps.  The kernel takes the tensor-core
// kernel's layout with fp32 FMAs in place of mma:
//   * the split's whole K tile, then its V tile, are copied with 16-byte
//     cp.async in two commit groups, so the scores run while V lands;
//     rows past the split's valid length are not copied (their scores
//     are masked, and P V stops at the valid length).  Rows stay
//     unpadded in the storage type: every read below has a warp's lanes
//     on consecutive 16-byte chunks of consecutive rows, which hit
//     distinct banks without padding;
//   * all 8 warps compute scores: warp w takes keys 8w .. 8w + 7, the
//     lanes of one dot product split D in 16-byte chunks (min(D / VEC,
//     32) lanes; the other lanes of the warp take other keys), the query
//     rows of a block of kRows sit in registers against each K chunk, and
//     the partial sums meet by shuffles;
//   * one softmax over the split's 64 keys (no second tile, no rescale);
//   * P V: threads run along D in 16-byte chunks and the key groups split
//     the keys; partial sums meet by shuffles within a warp, then across
//     warps in shared memory laid over the K tile, which is dead by then;
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

// The combine, both routes: one block per (row of the group, KV head,
// batch row), threads along D.  It reads each live split's m and l once
// into shared memory, computes each split's weight once, and sums the
// partials with independent 16-byte loads.  (Folding it into the split
// kernel -- the last block of a (b, hk) to finish combines -- needs a
// counter zeroed for every call, which is a launch of its own.)

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
         (D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

size_t smem_bytes(int rep, int D, size_t elem) {
  // k and v (64 x D, storage type); q (rep x D), p (rep rounded up to
  // kRows, x 64) and (m, l) of each row in fp32
  const size_t rp = (size_t)(rep + kRows - 1) / kRows * kRows;
  return elem * 2 * kSplit * D +
         sizeof(float) * ((size_t)rep * D + rp * kSplit + 2 * (size_t)rep);
}

size_t tc_smem_bytes(int D) {
  // q (16 x D+8), k and v (64 x D+8), p (16 x 64+8) bf16; row max and
  // row sum of each warp (2 x 8 x 16 floats)
  return 2 * ((size_t)kTcRows * (D + 8) + 2 * (size_t)kSplit * (D + 8) +
              kTcRows * (kSplit + 8)) +
         sizeof(float) * 2 * kWarps * kTcRows;
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
  // scores: LPK lanes per dot product, GPW dot products per warp pass,
  // CPL chunks per lane
  constexpr int LPK = CH < 32 ? CH : 32;
  constexpr int GPW = 32 / LPK;
  constexpr int CPL = CH / LPK;
  // P V: KG key groups of CH threads; NP partials of each output left
  // after the shuffles (one per warp, or per key group when CH >= 32)
  constexpr int KG = kThreads / CH;
  constexpr int NP = CH < 32 ? kWarps : KG;
  static_assert(D % VEC == 0 && CH <= 64, "a row is 1 .. 64 chunks");
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

  // O = P V: thread (key group kg, chunk c) over keys kg, kg + KG, ...
  const int c = tid % CH, kg = tid / CH;
  const size_t part = (size_t)(b * Hkv + hk) * gridDim.x + split;
  for (int r0 = 0; r0 < rep; r0 += kRows) {
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
    if (CH < 32) {                        // key groups within a warp
#pragma unroll
      for (int off = CH; off < 32; off <<= 1)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
    __syncthreads();                      // the last block's sums are read
    if (CH >= 32 || lane < CH) {
      const int pi = CH < 32 ? warp : kg;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(red + (pi * kRows + r) * D + c * VEC +
                                     e) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                          acc[r][e + 3]);
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

// Tensor-core split kernel (bf16): one 64-row split of one (KV head,
// batch row), the group's rep query heads as the 16 mma rows.  Same
// outputs as decode_kernel.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                 const bf16* __restrict__ vc, const int* __restrict__ lengths,
                 bf16* __restrict__ o, float* __restrict__ ws_acc,
                 float* __restrict__ ws_ml, int S, int H, int Hkv,
                 float scale) {
  constexpr int RS = D + 8;               // K/V/Q row stride (elements)
  constexpr int PS = kSplit + 8;          // P row stride
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr int NPAIR = D / 16;           // 16-column output slabs
  constexpr int PPW = (NPAIR + kWarps - 1) / kWarps;  // slabs per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTcRows * RS;
  bf16* vs = ks + kSplit * RS;
  bf16* ps = vs + kSplit * RS;
  float* red_m = reinterpret_cast<float*>(ps + kTcRows * PS);
  float* red_l = red_m + kWarps * kTcRows;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const int start = split * kSplit;
  const int end = min(start + kSplit, min(lengths[b], S));
  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * D;
  if (start >= end) {
    if (ws_acc == nullptr)              // one split and an empty row: 0
      for (int i = tid; i < rep * D; i += kThreads)
        o[q_off + i] = __float2bfloat16(0.f);
    return;
  }

  // Q and K (group 0), then V (group 1); rows past the group or past
  // `end` are zero-filled, so masked keys meet V rows of 0
  for (int i = tid; i < kTcRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < rep;
    mma::cp_async16(qs + r * RS + c * 8, q + q_off + (ok ? r * D + c * 8 : 0),
                    ok ? 16 : 0);
  }
  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* kb = kc + ((size_t)b * S * Hkv + hk) * D;
  const bf16* vb = vc + ((size_t)b * S * Hkv + hk) * D;
  for (int i = tid; i < kSplit * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = start + r < end;
    mma::cp_async16(ks + r * RS + c * 8,
                    kb + (size_t)(ok ? start + r : start) * kv_stride + c * 8,
                    ok ? 16 : 0);
  }
  mma::cp_async_commit();
  for (int i = tid; i < kSplit * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = start + r < end;
    mma::cp_async16(vs + r * RS + c * 8,
                    vb + (size_t)(ok ? start + r : start) * kv_stride + c * 8,
                    ok ? 16 : 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  __syncthreads();                        // Q and K have landed

  // S = Q K^T: warp w takes keys 8w .. 8w + 7; two accumulators halve
  // the dependent mma chain
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], bb[2];
    mma::ldsm_x4(a, qs + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
    mma::ldsm_x2(bb, ks + (warp * 8 + lane % 8) * RS + kk * 16 +
                         ((lane / 8) % 2) * 8);
    if (kk % 2)
      mma::mma_bf16(s1, a, bb[0], bb[1]);
    else
      mma::mma_bf16(s0, a, bb[0], bb[1]);
  }
  // this lane's scores: rows g (e = 0, 1) and g + 8 (e = 2, 3), keys
  // start + 8 warp + 2t + (e & 1)
  float s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = start + warp * 8 + 2 * t + (e & 1);
    s[e] = key < end ? (s0[e] + s1[e]) * scale : kNegInf;
  }
  float mx[2] = {fmaxf(s[0], s[1]), fmaxf(s[2], s[3])};
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
  float m[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    m[0] = fmaxf(m[0], red_m[w * kTcRows + g]);
    m[1] = fmaxf(m[1], red_m[w * kTcRows + g + 8]);
  }
  const float p0 = expf(s[0] - m[0]), p1 = expf(s[1] - m[0]);
  const float p2 = expf(s[2] - m[1]), p3 = expf(s[3] - m[1]);
  float rs[2] = {p0 + p1, p2 + p3};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
  if (t == 0) {
    red_l[warp * kTcRows + g] = rs[0];
    red_l[warp * kTcRows + g + 8] = rs[1];
  }
  *reinterpret_cast<uint32_t*>(ps + g * PS + warp * 8 + 2 * t) =
      mma::pack_bf16(p0, p1);
  *reinterpret_cast<uint32_t*>(ps + (g + 8) * PS + warp * 8 + 2 * t) =
      mma::pack_bf16(p2, p3);
  mma::cp_async_wait<0>();
  __syncthreads();                        // V, P and the row sums

  // O = P V: warp w takes the 16-column slabs w, w + 8, ...
  float acc[PPW][2][4];
#pragma unroll
  for (int j = 0; j < PPW; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSplit / 16; ++kk) {
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

  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    l[0] += red_l[w * kTcRows + g];
    l[1] += red_l[w * kTcRows + g + 8];
  }
  const size_t part = (size_t)(b * Hkv + hk) * gridDim.x + split;
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    const int slab = warp + j * kWarps;
    if (slab >= NPAIR) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = slab * 16 + n * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // rows g, g + 8
        const int r = g + 8 * h;
        if (r >= rep) continue;
        const float x0 = acc[j][n][2 * h], x1 = acc[j][n][2 * h + 1];
        if (ws_acc == nullptr) {
          const float inv = 1.f / fmaxf(l[h], 1e-30f);
          *reinterpret_cast<uint32_t*>(o + q_off + r * D + col) =
              mma::pack_bf16(x0 * inv, x1 * inv);
        } else {
          *reinterpret_cast<float2*>(ws_acc + (part * rep + r) * D + col) =
              make_float2(x0, x1);
        }
      }
    }
  }
  if (ws_acc != nullptr && warp == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < rep) {
        ws_ml[(part * rep + r) * 2] = m[h];
        ws_ml[(part * rep + r) * 2 + 1] = l[h];
      }
    }
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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const int* lengths,
              void* o, float* ws_acc, float* ws_ml, int n_split, int B,
              int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(D);
  auto kernel = decode_tc_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, static_cast<bf16*>(o), ws_acc,
      ws_ml, S, H, Hkv, scale);
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
    case 256: return launch<T, 256>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    default: return -1;
  }
}

int dispatch_tc(int D, const void* q, const void* k, const void* v,
                const int* lengths, void* o, float* wa, float* wm,
                int n_split, int B, int S, int H, int Hkv, float scale,
                cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 32: return launch_tc<32>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 64: return launch_tc<64>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 128: return launch_tc<128>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
    case 256: return launch_tc<256>(q, k, v, lengths, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
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

// Bytes of shared memory one split block of `route` (1 CUDA cores, 2
// tensor cores) needs for dtype (0 fp32, 1 bf16); the wrapper refuses a
// group that does not fit the card's 227 KB.
extern "C" long long decode_attention_smem_bytes(int rep, int D, int dtype,
                                                 int route) {
  return (long long)(route == 2 ? tc_smem_bytes(D)
                                : smem_bytes(rep, D, dtype == 1 ? 2 : 4));
}

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// shape / dtype / route this library has no kernel for.  dtype: 0 fp32,
// 1 bf16; route: 0 by shape, 1 CUDA cores, 2 tensor cores.  n_split must
// be ceil(S / 64); ws holds B * Hkv * n_split * rep * (D + 2) floats
// (acc, then m and l; unused when n_split == 1).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* ws, int n_split, int B,
                                    int S, int H, int Hkv, int D,
                                    float scale, int dtype, int route,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 ||
      n_split != (S + kSplit - 1) / kSplit ||
      2 * n_split * sizeof(float) > (size_t)kMaxCombineSmem ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int rep = H / Hkv;
  float* wa = n_split > 1 ? static_cast<float*>(ws) : nullptr;
  float* wm = wa ? wa + (size_t)B * Hkv * n_split * rep * D : nullptr;
  if (route == 0) route = tc_takes(dtype, D, rep) ? 2 : 1;
  int err;
  if (route == 2) {
    if (!tc_takes(dtype, D, rep)) return -1;
    err = dispatch_tc(D, q, k, v, len, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
  } else if (route == 1) {
    err = dtype == 0
        ? dispatch_d<float>(D, q, k, v, len, o, wa, wm, n_split, B, S, H, Hkv, scale, s)
        : dispatch_d<bf16>(D, q, k, v, len, o, wa, wm, n_split, B, S, H, Hkv, scale, s);
  } else {
    return -1;
  }
  if (err != 0 || n_split == 1) return err;
  return dtype == 0
      ? launch_combine<float>(wa, wm, len, o, n_split, B, S, H, Hkv, D, s)
      : launch_combine<bf16>(wa, wm, len, o, n_split, B, S, H, Hkv, D, s);
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
