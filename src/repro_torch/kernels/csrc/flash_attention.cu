// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): causal / sliding-window GQA
// attention forward with an online softmax kept in fp32.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), out (B, Sq, H, D), all
// contiguous, fp32 or bf16; query head h reads KV head h / (H / Hkv).
//
// Design, both routes.  One block per (64-row Q tile, head, batch).  The
// TPU kernel carries m/l/acc in VMEM scratch across a sequential KV grid
// axis; here a loop inside the block walks the KV tiles instead, and it
// visits only the tiles that the causal and window masks leave visible,
// so masked work is skipped as on the TPU.  In the CUDA-core kernel K and
// V tiles (32 rows) are staged through shared memory as fp32; each query
// row is owned by 4 neighbouring lanes of one warp, which split the row's
// 32 scores and its D output columns, so the row's softmax reductions are
// two shuffles and the row's probabilities never leave the warp.  The
// tensor-core kernel is described below.  Masking uses the finite constant
// -0.7 * FLT_MAX of the TPU kernel: a row whose first visible tile is fully
// masked for it accumulates exp(0) = 1 terms that the first real score
// wipes out with alpha = exp(NEG_INF - m) = 0, where -inf would give NaN.
//
// What bounds it on an H100.  At the serving shapes (S = 512..1024,
// D = 256, 4 query heads on 1 KV head) the card's own bound is a few
// microseconds either way: 4 * B * H * D * S^2 / 2 flops against
// 2 * B * S * (H + Hkv) * D elements moved, about 50 flops per bf16 byte,
// below the ~295 at which the tensor cores rather than memory limit.
//
// Three routes, chosen by dtype and shape before the launch (never
// after a failure): `flash_attention_fwd`'s `route` argument is 0 (by
// shape), 1 (CUDA cores), 2 (tensor cores) or 3 (short sequences), and
// it returns -1 where a forced route cannot take the shape.
//
// CUDA-core route (fp32 and head dim 8 beyond the short route's
// limits): the fp32 kernel below.  It is
// limited by issuing shared-memory loads, so the inner products read q,
// k, v and p as 16-byte vectors (rows padded to keep them aligned and the
// banks distinct) and each lane owns 4-column groups of the output.  At
// D = 256 its 139 KB of shared memory allows one block per SM.  fp32
// stays here because TF32 tensor cores (~1e-3) miss its 2e-5 tolerance;
// head dim 8 because mma needs a depth of 16.
//
// Tensor-core route (bf16, D = 16..256): `flash_tc_kernel`.  The
// CUDA-core kernel is bound by issue rate and latency, not by the card:
// fp32 FMAs at 1/15 of the bf16 tensor rate, K/V staged as fp32 (twice
// the shared-memory traffic) and tile loads that wait for compute.  At
// the serving shapes one wave holds every block (128 at gemma3-1b B = 4),
// so the time is one block's chain of KV tiles.  So: S = Q K^T and
// O += P V by mma.sync m16n8k16 (bf16 in, fp32 accumulate) with operands
// from ldmatrix (.trans for V); K and V stay bf16 in 32-row tiles, rows
// padded by 16 bytes so ldmatrix's 8 row reads hit distinct banks.  A
// block is two warp groups of 4 warps, each warp owning 16 query rows of
// the 64-row Q tile (shared in shared memory); the groups take alternate
// KV tiles, each through its own two-stage ring filled by 16-byte
// cp.async copies (tile t+2 loads while tile t computes), which halves
// the chain and puts two warps on each scheduler to hide the mma and
// ldmatrix latency.  At the end group 1 hands its (m, l, O) fragments to
// group 0 through the idle rings and group 0 merges the two online
// softmaxes and writes O.  The online softmax runs on the fp32
// accumulator fragment (row max and sum across the 4 lanes of a row by
// two shuffles), in the log2 domain, and P goes to bf16 in registers as
// the A operand of P V.  Under causal masking the grid's slowest axis
// walks Q tiles heaviest first, so the long rows start in the first
// wave; a warp skips a tile that is wholly masked for its rows, and only
// tiles that cross the diagonal, the window edge or the end of the keys
// apply the elementwise mask.  At D = 256 the O accumulator is 128 fp32
// registers a thread; shared memory is 165 KB (Q tile + 2 groups x 2
// stages x (K + V)), one block per SM.
//
// Short route (fp32, Sq and Sk <= 16, D = 8, 16 or 32): `flash_short_kernel`,
// attn-tiny's path (2 heads of 16 over 16, 8 or 4 positions, B up to
// 256).  There the work is ~2 KB per (b, h) and ~4 M FMAs for B = 256:
// the card's bound is bytes (~0.6 us at B = 256), under the cost of one
// launch, so what counts is the launch, the trips to device memory and
// the threads that do nothing.  The CUDA-core kernel spends its time on
// all three: 64 query rows and a 32-row KV tile per block, so at S = 16
// three quarters of the threads load zeros and score masked rows; scalar
// loads of Q and then of K/V with two block barriers between them (two
// dependent trips to device memory); 256 threads per (b, h).  So: one
// warp per (b, h) and
// its whole (<= 16-row) query tile, four warps a block on consecutive
// (b, h), so B = 256, H = 2 is 128 blocks, one wave.  The warp issues all
// of its loads before any arithmetic: K and V by 16-byte cp.async into
// its own slice of shared memory (rows past Sk zero-filled), each lane's
// query row by 16-byte loads into registers; then one wait and a
// __syncwarp, and no block barrier at all.  Lane 2r + t owns query row r
// and the key slots t, t + 2, ..., t + 14: its 8 scores, their max and
// sum (one shuffle each with its partner lane) and its share of P V
// stay in registers; the partner lanes add their halves of the output
// row by shuffles and each writes 16 bytes at a time.  Sk <= 16 is one
// tile, so the softmax needs no rescaling.  Masking is by position
// against the true Sq and Sk, and a masked slot contributes an exact 0
// (p = exp(-0.7 FLT_MAX - m) = 0, zero-filled V), in a slot order that
// does not depend on Sk: a call padded to 16 with zeros gives the same
// bits as the same call unpadded.  Products and sums stay fp32 on the
// CUDA cores (TF32 misses the 2e-5 tolerance; the FMAs take ~0.1 us).
// Splitting a (b, h) over two warps of 8 rows, which halves each warp's
// arithmetic, measured slower at every attn-tiny shape: the time above
// an empty kernel's is the memory round trip, not the FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * FLT_MAX
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBKV = 32;                 // KV rows per tile
constexpr int kThreads = 256;
constexpr int kLanesPerRow = kThreads / kBQ;   // 4
constexpr int kPS = kBKV + 4;            // P tile row stride (16-B aligned)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile (BQ x D+4), k tile (BKV x D+4), v tile (BKV x D), p (BQ x BKV+4)
  return sizeof(float) *
         (kBQ * (D + 4) + kBKV * (D + 4) + kBKV * D + kBQ * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Hkv, int causal, int window, float scale) {
  static_assert(D % kLanesPerRow == 0, "D must be a multiple of 4");
  static_assert(kBKV * D % kThreads == 0, "tile loads must split evenly");
  // row stride D + 4: 16-byte aligned, and rows 4 banks apart, so the
  // 2 q rows / 4 k rows a quarter-warp reads never share a bank
  constexpr int RP = D + 4;
  constexpr int kCols = D / kLanesPerRow;      // output columns per lane
  constexpr int kScores = kBKV / kLanesPerRow;  // scores per lane per tile
  // lanes own 4-column groups (16-byte V reads) when D allows it
  constexpr bool kVec = kCols % 4 == 0;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // kBQ x RP
  float* ks = qs + kBQ * RP;        // kBKV x RP
  float* vs = ks + kBKV * RP;       // kBKV x D
  float* ps = vs + kBKV * D;        // kBQ x kPS

  const int q_lo = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;
  const int qpos = q_lo + row;

#pragma unroll 8
  for (int j = 0; j < kBQ * D / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / D, d = i % D;
    const int s = q_lo + r;
    float x = 0.f;
    if (s < Sq) x = to_f32(q[((size_t)(b * Sq + s) * H + h) * D + d]);
    qs[r * RP + d] = x;
  }

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // visible KV tiles of this query tile (the TPU kernel's pl.when test)
  const int n_tiles = (Sk + kBKV - 1) / kBKV;
  int hi = n_tiles;
  if (causal) hi = min(n_tiles, (q_lo + kBQ - 1) / kBKV + 1);
  int lo = 0;
  if (window > 0 && q_lo - window + 1 > 0) lo = (q_lo - window + 1) / kBKV;

  const float* qrow = qs + row * RP;
  float* prow = ps + row * kPS;
  for (int kt = lo; kt < hi; ++kt) {
    const int k_lo = kt * kBKV;
    __syncthreads();  // the previous tile's K/V reads are done
    // a compile-time trip count keeps several loads of the tile in flight
#pragma unroll 8
    for (int j = 0; j < kBKV * D / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / D, d = i % D;
      const int s = k_lo + r;
      float kx = 0.f, vx = 0.f;
      if (s < Sk) {
        const size_t off = ((size_t)(b * Sk + s) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r * RP + d] = kx;
      vs[r * D + d] = vx;
    }
    __syncthreads();

    // scores of keys sub, sub+4, ..., sub+28 against this lane's row
    float sc[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 q4 = ld4(qrow + d);
#pragma unroll
      for (int j = 0; j < kScores; ++j) {
        const float4 k4 = ld4(ks + (sub + kLanesPerRow * j) * RP + d);
        sc[j] = fmaf(q4.x, k4.x, sc[j]);
        sc[j] = fmaf(q4.y, k4.y, sc[j]);
        sc[j] = fmaf(q4.z, k4.z, sc[j]);
        sc[j] = fmaf(q4.w, k4.w, sc[j]);
      }
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int kpos = k_lo + sub + kLanesPerRow * j;
      bool keep = kpos < Sk;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      sc[j] = keep ? sc[j] * scale : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      prow[sub + kLanesPerRow * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities are visible to its 4 lanes

#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    for (int kc = 0; kc < kBKV; kc += 4) {
      const float4 p4 = ld4(prow + kc);
      const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kc + u) * D;
        if constexpr (kVec) {
#pragma unroll
          for (int g = 0; g < kCols / 4; ++g) {
            const float4 v4 = ld4(vrow + g * 4 * kLanesPerRow + sub * 4);
            acc[4 * g + 0] = fmaf(pk[u], v4.x, acc[4 * g + 0]);
            acc[4 * g + 1] = fmaf(pk[u], v4.y, acc[4 * g + 1]);
            acc[4 * g + 2] = fmaf(pk[u], v4.z, acc[4 * g + 2]);
            acc[4 * g + 3] = fmaf(pk[u], v4.w, acc[4 * g + 3]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[c] = fmaf(pk[u], vrow[sub + kLanesPerRow * c], acc[c]);
        }
      }
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)(b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kVec ? (c / 4) * 4 * kLanesPerRow + sub * 4 + c % 4
                           : sub + kLanesPerRow * c;
      orow[col] = from_f32<T>(acc[c] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
               float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    default: return -1;
  }
}

// ---------------------------------------------------------------------
// tensor-core route (bf16)
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcBQ = 64;                // query rows per block
constexpr int kTcBKV = 32;               // KV rows per tile
constexpr int kTcGroupThreads = 128;     // a warp group: 4 warps x 16 rows
constexpr int kTcThreads = 2 * kTcGroupThreads;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_kv_bytes() {
  // per warp group two stages of K and V
  return sizeof(bf16) * (size_t)2 * 2 * 2 * kTcBKV * (D + 8);
}

template <int D>
constexpr size_t tc_merge_bytes() {
  // group 1's O fragments, then its m and l, one float4 a lane each
  return 16 * (size_t)4 * 32 * (D / 8 + 1);
}

template <int D>
constexpr size_t tc_smem_bytes() {
  // the Q tile, then the K/V rings, which the merge reuses at the end
  return sizeof(bf16) * (size_t)kTcBQ * (D + 8) +
         (tc_kv_bytes<D>() > tc_merge_bytes<D>() ? tc_kv_bytes<D>()
                                                 : tc_merge_bytes<D>());
}

// Rows [row0, row0 + ROWS) of a matrix whose row r starts at src + r *
// stride into a ROWS x (D + 8) tile, by NT threads; rows >= nrows are
// zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int row0, int nrows,
                                             size_t stride, int tid) {
  constexpr int kChunks = D / 8;          // 16-byte chunks per row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (kTotal % NT != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = i % kChunks;
    const int s = row0 + r;
    const bool ok = s < nrows;
    mma::cp_async16(dst + r * (D + 8) + c * 8,
                    src + (size_t)(ok ? s : 0) * stride + c * 8,
                    ok ? 16 : 0);
  }
}

// Barrier of one warp group (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group),
               "n"(kTcGroupThreads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                int Sk, int H, int Hkv, int causal, int window,
                float scale_log2) {
  constexpr int RS = D + 8;               // shared row stride (elements)
  constexpr int NT = kTcBKV / 8;          // score n-tiles per warp
  constexpr int DT = D / 8;               // output n-tiles per warp
  constexpr int TILE = kTcBKV * RS;       // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv0 = qs + kTcBQ * RS;            // K/V rings, then the merge

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_lo = qt * kTcBQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int grp = warp / 4, wq = warp % 4;  // group; its 16 rows: wq
  const int gtid = tid % kTcGroupThreads;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q_lo + wq * 16 + g;   // this lane's rows: a, a + 8
  bf16* ring = kv0 + grp * 4 * TILE;      // [stage][K, V]

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * D;

  // visible KV tiles of this query tile (the TPU kernel's pl.when test);
  // group 0 takes tiles lo, lo + 2, ..., group 1 lo + 1, lo + 3, ...
  const int n_tiles = (Sk + kTcBKV - 1) / kTcBKV;
  int hi = n_tiles;
  if (causal) hi = min(n_tiles, (q_lo + kTcBQ - 1) / kTcBKV + 1);
  int lo = 0;
  if (window > 0 && q_lo - window + 1 > 0) lo = (q_lo - window + 1) / kTcBKV;

  tc_load_tile<D, kTcBQ, kTcThreads>(qs, qb, q_lo, Sq, q_stride, tid);
  if (lo + grp < hi) {
    tc_load_tile<D, kTcBKV, kTcGroupThreads>(
        ring, kb, (lo + grp) * kTcBKV, Sk, kv_stride, gtid);
    tc_load_tile<D, kTcBKV, kTcGroupThreads>(
        ring + TILE, vb, (lo + grp) * kTcBKV, Sk, kv_stride, gtid);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();                       // Q and each group's first tile

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this lane's share of the row sum

  int st = 0;
  for (int kt = lo + grp; kt < hi; kt += 2, st ^= 1) {
    if (kt + 2 < hi) {                   // the group's next tile loads now
      bf16* nxt = ring + (st ^ 1) * 2 * TILE;
      tc_load_tile<D, kTcBKV, kTcGroupThreads>(
          nxt, kb, (kt + 2) * kTcBKV, Sk, kv_stride, gtid);
      tc_load_tile<D, kTcBKV, kTcGroupThreads>(
          nxt + TILE, vb, (kt + 2) * kTcBKV, Sk, kv_stride, gtid);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    group_sync(grp);
    const bf16* kst = ring + st * 2 * TILE;
    const bf16* vst = kst + TILE;
    const int k_lo = kt * kTcBKV;
    // a tile wholly masked for this warp's 16 rows changes nothing
    const bool skip =
        (causal && k_lo > q_lo + wq * 16 + 15) ||
        (window > 0 && k_lo + kTcBKV - 1 <= q_lo + wq * 16 - window);
    if (!skip) {
      // S = Q K^T: 16 rows x 32 keys per warp
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        mma::ldsm_x4(a, qs + (wq * 16 + lane % 16) * RS + kk * 16 +
                            (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          mma::ldsm_x4(bb, kst + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                               kk * 16 + ((lane / 8) % 2) * 8);
          mma::mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma::mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // scale into the log2 domain; mask only tiles on an edge
      const bool edge = (causal && k_lo + kTcBKV - 1 > q_lo + wq * 16) ||
                        k_lo + kTcBKV > Sk ||
                        (window > 0 &&
                         k_lo + window <= q_lo + wq * 16 + 15);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int qpos = row_a + (e >= 2 ? 8 : 0);
            const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
            bool keep = kpos < Sk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) x = kNegInf;
          }
          s[j][e] = x;
        }

      // online softmax on the fragment: rows a (e = 0, 1), a + 8 (2, 3)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
      uint32_t pa[NT / 2][4];            // P as the A fragments of P V
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
        const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[j / 2][(j % 2) * 2] = mma::pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = mma::pack_bf16(p2, p3);
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bb[4];
          mma::ldsm_x4_t(bb, vst + (kk * 16 + lane % 8 +
                                    ((lane / 8) % 2) * 8) * RS +
                                 dp * 16 + (lane / 16) * 8);
          mma::mma_bf16(acc[2 * dp], pa[kk], bb[0], bb[1]);
          mma::mma_bf16(acc[2 * dp + 1], pa[kk], bb[2], bb[3]);
        }
    }
    group_sync(grp);                     // this stage may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // merge the two groups' partial softmax states: group 1 hands its
  // fragments to group 0 through the (now idle) K/V rings
  float4* xfer = reinterpret_cast<float4*>(kv0);
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      xfer[(wq * DT + d) * 32 + lane] =
          make_float4(acc[d][0], acc[d][1], acc[d][2], acc[d][3]);
    xfer[(4 * DT + wq) * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (grp == 1) return;
  const float4 ml = xfer[(4 * DT + wq) * 32 + lane];
  const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mm = fmaxf(m[r], m1[r]);
    a0[r] = exp2f(m[r] - mm);
    a1[r] = exp2f(m1[r] - mm);
    inv[r] = 1.f / fmaxf(l[r] * a0[r] + l1[r] * a1[r], 1e-30f);
  }
  bf16* orow_a = o + ((size_t)(b * Sq + row_a) * H + h) * D + 2 * t;
  bf16* orow_b = orow_a + (size_t)8 * H * D;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const float4 x1 = xfer[(wq * DT + d) * 32 + lane];
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(orow_a + d * 8) = mma::pack_bf16(
          (acc[d][0] * a0[0] + x1.x * a1[0]) * inv[0],
          (acc[d][1] * a0[0] + x1.y * a1[0]) * inv[0]);
    if (row_a + 8 < Sq)
      *reinterpret_cast<uint32_t*>(orow_b + d * 8) = mma::pack_bf16(
          (acc[d][2] * a0[1] + x1.z * a1[1]) * inv[1],
          (acc[d][3] * a0[1] + x1.w * a1[1]) * inv[1]);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int Hkv, int causal, int window,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_tc_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B, (Sq + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, Hkv,
      causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int dispatch_tc(int D, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int Hkv, int causal,
                int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 32: return launch_tc<32>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 64: return launch_tc<64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 128: return launch_tc<128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 256: return launch_tc<256>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    default: return -1;
  }
}

bool tc_takes(int dtype, int D) {
  return dtype == 1 && (D == 16 || D == 32 || D == 64 || D == 128 ||
                        D == 256);
}

// ---------------------------------------------------------------------
// short route (fp32, Sq and Sk <= 16)
// ---------------------------------------------------------------------
constexpr int kShortS = 16;              // most query rows, most keys
constexpr int kShortWarps = 4;           // warps a block, one (b, h) each
constexpr int kShortSlots = kShortS / 2;  // key slots a lane owns

template <int D>
__global__ void __launch_bounds__(32 * kShortWarps)
flash_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   int BH, int Sq, int Sk, int H, int Hkv, int causal,
                   int window, float scale) {
  // row stride D + 4: 16-byte aligned, and the two rows one load reads
  // (slot 2i for even lanes, 2i + 1 for odd ones) on distinct banks
  constexpr int RS = D + 4;
  constexpr int C4 = D / 4;               // 16-byte pieces of a row
  constexpr int HALF = D / 2;             // output columns a lane writes
  static_assert(kShortS * C4 % 32 == 0, "K/V copies must split evenly");
  static_assert(HALF % 4 == 0, "a lane writes whole 16-byte pieces");
  __shared__ __align__(16) float kv_smem[kShortWarps][2][kShortS * RS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * kShortWarps + warp;
  if (item >= BH) return;                 // no block barrier follows
  const int b = item / H, h = item % H;
  const int hk = h / (H / Hkv);
  float* ks = kv_smem[warp][0];
  float* vs = kv_smem[warp][1];

  // every load first: K and V of (b, hk) into this warp's shared memory
  // (rows >= Sk zero-filled), then this lane's query row into registers
  const size_t kv_stride = (size_t)Hkv * D;
  const float* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Sk * Hkv + hk) * D;
#pragma unroll
  for (int it = 0; it < kShortS * C4 / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / C4, c = i % C4;
    const bool ok = r < Sk;
    const size_t off = (size_t)(ok ? r : 0) * kv_stride + c * 4;
    mma::cp_async16(ks + r * RS + c * 4, kb + off, ok ? 16 : 0);
    mma::cp_async16(vs + r * RS + c * 4, vb + off, ok ? 16 : 0);
  }
  mma::cp_async_commit();

  const int r = lane / 2, t = lane % 2;   // query row r, key slots t + 2i
  float qr[D];
  const float4* q4 = reinterpret_cast<const float4*>(
      q + ((size_t)(b * Sq + r) * H + h) * D);
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float4 x = r < Sq ? __ldg(q4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c + 0] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }
  mma::cp_async_wait<0>();
  __syncwarp();

  // scores of slots t, t + 2, ..., t + 14, masked by position
  float s[kShortSlots];
#pragma unroll
  for (int i = 0; i < kShortSlots; ++i) {
    const int j = 2 * i + t;
    const float* krow = ks + j * RS;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const float4 k4 = ld4(krow + 4 * c);
      dot = fmaf(qr[4 * c + 0], k4.x, dot);
      dot = fmaf(qr[4 * c + 1], k4.y, dot);
      dot = fmaf(qr[4 * c + 2], k4.z, dot);
      dot = fmaf(qr[4 * c + 3], k4.w, dot);
    }
    bool keep = j < Sk;
    if (causal) keep = keep && j <= r;
    if (window > 0) keep = keep && j > r - window;
    s[i] = keep ? dot * scale : kNegInf;
  }
  // one tile holds every key: the softmax needs no rescaling
  float m = kNegInf;
#pragma unroll
  for (int i = 0; i < kShortSlots; ++i) m = fmaxf(m, s[i]);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < kShortSlots; ++i) {
    s[i] = expf(s[i] - m);
    l += s[i];
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // this lane's slots of P V, every column
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kShortSlots; ++i) {
    const float* vrow = vs + (2 * i + t) * RS;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const float4 v4 = ld4(vrow + 4 * c);
      acc[4 * c + 0] = fmaf(s[i], v4.x, acc[4 * c + 0]);
      acc[4 * c + 1] = fmaf(s[i], v4.y, acc[4 * c + 1]);
      acc[4 * c + 2] = fmaf(s[i], v4.z, acc[4 * c + 2]);
      acc[4 * c + 3] = fmaf(s[i], v4.w, acc[4 * c + 3]);
    }
  }
  // the partner lanes add their halves: lane t keeps columns
  // [t * HALF, (t + 1) * HALF) and sends the other half
  float out[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float mine = t ? acc[HALF + c] : acc[c];
    const float other = t ? acc[c] : acc[HALF + c];
    out[c] = mine + __shfl_xor_sync(0xffffffffu, other, 1);
  }
  if (r < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float4* o4 = reinterpret_cast<float4*>(
        o + ((size_t)(b * Sq + r) * H + h) * D + t * HALF);
#pragma unroll
    for (int c = 0; c < HALF / 4; ++c)
      o4[c] = make_float4(out[4 * c + 0] * inv, out[4 * c + 1] * inv,
                          out[4 * c + 2] * inv, out[4 * c + 3] * inv);
  }
}

template <int D>
int launch_short(const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Sk, int H, int Hkv, int causal,
                 int window, float scale, cudaStream_t stream) {
  const int BH = B * H;
  const dim3 grid((BH + kShortWarps - 1) / kShortWarps);
  flash_short_kernel<D><<<grid, 32 * kShortWarps, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, Sq, Sk, H,
      Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_short(int D, const void* q, const void* k, const void* v,
                   void* o, int B, int Sq, int Sk, int H, int Hkv,
                   int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch_short<8>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 16: return launch_short<16>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 32: return launch_short<32>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    default: return -1;
  }
}

bool short_takes(int dtype, int Sq, int Sk, int D) {
  return dtype == 0 && Sq >= 1 && Sq <= kShortS && Sk >= 1 &&
         Sk <= kShortS && (D == 8 || D == 16 || D == 32);
}

}  // namespace

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// shape / dtype the chosen route is not built for.  dtype: 0 fp32, 1
// bf16.  route: 0 by shape (tensor cores for bf16 with D = 16..256, the
// short route for fp32 with Sq, Sk <= 16 and D = 8, 16 or 32, else CUDA
// cores), 1 CUDA cores, 2 tensor cores, 3 short.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int causal,
                                   int window, float scale, int dtype,
                                   int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0)
    route = tc_takes(dtype, D) ? 2 : short_takes(dtype, Sq, Sk, D) ? 3 : 1;
  if (route == 2) {
    if (!tc_takes(dtype, D)) return -1;
    return dispatch_tc(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
  }
  if (route == 3) {
    if (!short_takes(dtype, Sq, Sk, D)) return -1;
    return dispatch_short(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
  }
  if (route != 1) return -1;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
  return -1;
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
