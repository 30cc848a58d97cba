// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): causal / sliding-window GQA
// attention forward with an online softmax kept in fp32.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), out (B, Sq, H, D), all
// contiguous, fp32 or bf16; query head h reads KV head h / (H / Hkv).
//
// Design, the two tiled routes.  One block per (64-row Q tile, head,
// batch).  The TPU kernel carries m/l/acc in VMEM scratch across a
// sequential KV grid axis; here a loop inside the block walks the KV
// tiles instead, and it visits only the tiles that the causal and window
// masks leave visible, so masked work is skipped as on the TPU.  Masking
// uses the finite constant -0.7 * FLT_MAX of the TPU kernel: a row whose
// first visible tile is fully masked for it accumulates exp(0) = 1 terms
// that the first real score wipes out with alpha = exp(NEG_INF - m) = 0,
// where -inf would give NaN.
//
// What bounds it on an H100.  At the serving shapes (S = 512..1024,
// D = 256, 4 query heads on 1 KV head) the card's own bound is a few
// microseconds either way: 4 * B * H * D * S^2 / 2 flops against
// 2 * B * S * (H + Hkv) * D elements moved, about 50 flops per bf16 byte,
// below the ~295 at which the tensor cores rather than memory limit.
// But one wave holds every block (128 at gemma3-1b B = 4), so a call
// lasts as long as its heaviest block's chain of KV tiles: the last query
// tile's 512 keys, ~31 MFLOP, ~4 us at one SM's share of the dense bf16
// rate.  What counts is how close that chain runs to the SM's rate.
//
// Three routes, chosen by dtype and shape before the launch (never
// after a failure): `flash_attention_fwd`'s `route` argument is 0 (by
// shape), 1 (CUDA cores), 2 (tensor cores) or 3 (short sequences), and
// it returns -1 where a forced route cannot take the shape.
//
// CUDA-core route (fp32 and head dim 8 beyond the short route's
// limits): `flash_fwd_kernel`, K and V tiles (32 rows) staged through
// shared memory as fp32; each query row is owned by 4 neighbouring lanes
// of one warp, which split the row's 32 scores and its D output columns,
// so the row's softmax reductions are two shuffles and the row's
// probabilities never leave the warp.  It is limited by issuing
// shared-memory loads, so the inner products read q, k, v and p as
// 16-byte vectors (rows padded to keep them aligned and the banks
// distinct) and each lane owns 4-column groups of the output.  At
// D = 256 its 139 KB of shared memory allows one block per SM.  fp32
// stays here because TF32 tensor cores (~1e-3) miss its 2e-5 tolerance;
// head dim 8 because mma needs a depth of 16.
//
// Tensor-core route (bf16, D = 16..256): `flash_tc_kernel`, built from
// Hopper's own parts (hopper.cuh) so the chain runs on the tensor cores
// with nothing else in its way.  A block is two warpgroups that take
// alternate KV tiles against the same 64-row Q tile (wgmma's M):
//   * loads: one thread loads the Q tile once, and one thread of each
//     warpgroup keeps that group's ring of three K/V stages full by TMA
//     (4-d tensor maps, one box of 64 KV rows, 32 at D = 256, per 64
//     columns, 128/64/32-byte swizzled as wgmma reads them; a full
//     mbarrier a stage), refilling a stage once every warp of the group
//     is done with it, so no copy costs the group more than a few
//     instructions.  There is no producer warpgroup: ptxas gives every
//     thread of a block the launch bound's share of registers (168 with a
//     third warpgroup) whatever setmaxnreg grants later, and at D = 256
//     it then spilled and serialised the products; with two warpgroups a
//     thread may hold up to 255, and ptxas uses 182 at D = 256 (O alone
//     is 128 a thread), 138 at D = 128 and 82-109 up to D = 64, with no
//     spill at any head dim;
//   * products: S = Q K^T by wgmma with both operands K-major in shared
//     memory, O += P V by wgmma with P from registers (the accumulator
//     rounded to bf16 in pairs) and V MN-major.  Step n issues S_n and
//     P_{n-1} V_{n-1} together, runs the softmax of S_n while the second
//     product runs, and rescales O once neither is in flight (so ptxas
//     never serialises the products); the other group's products fill
//     the tensor cores during this one's softmax.  At the end group 1
//     hands its (m, l, O) to group 0 through the idle rings and group 0
//     merges the two online softmaxes and writes O.
// The numbers are those of the mma.sync kernel this one replaced: the
// log2-domain softmax on the fp32 accumulator (row max and sum across
// the 4 lanes of a row by two shuffles), P rounded to bf16, the mask
// applied only on tiles across an edge of a warp's 16 rows.  Rows past
// Sq or Sk arrive as zeros (TMA's out-of-bounds fill) and are masked by
// position.  Under causal masking the grid walks query tiles heaviest
// first.  Shared memory: the Q tile and the two rings (225 KB at
// D = 256); up to D = 64 two blocks share an SM.  The tensor maps are
// encoded on the host for each call (they hold the pointers), the
// kernel's attributes set once per device.
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

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
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
// tensor-core route (bf16): wgmma + TMA, two warpgroups
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcBQ = 64;                // query rows per block: wgmma's M
constexpr int kTcThreads = 2 * 128;      // two consumer warpgroups
constexpr int kTcStages = 3;             // K/V stages of each warpgroup
constexpr int kTensorMapError = -2;      // cuTensorMapEncodeTiled refused
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcTile {
  // KV rows a tile: 64, and 32 at D = 256 (six stages of 64 rows would
  // not fit the SM's shared memory)
  static constexpr int BKV = D == 256 ? 32 : 64;
  static constexpr int W = D < 64 ? D : 64;       // columns of a block
  static constexpr int NB = D / W;                // column blocks a row
  static constexpr int SW = 2 * W;                // swizzle bytes
  static constexpr int Q_BYTES = kTcBQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;    // one K or V tile
  static constexpr int RING = 2 * kTcStages * 2 * KV_BYTES;
  // group 1's O fragments, then its m and l, a float4 a thread each
  static constexpr int MERGE = 16 * 128 * (D / 8 + 1);
  static_assert(MERGE <= RING, "the merge reuses the ring");
  // alignment slack, Q, the two rings, then the barriers: Q's and each
  // stage's
  static constexpr size_t SMEM =
      1024 + Q_BYTES + RING + 8 * (1 + 2 * kTcStages);
  // blocks a SM: two up to D = 64 (at most 128 registers a thread), one
  // above (up to 255; O alone is 128 a thread at D = 256)
  static constexpr int BLOCKS = D <= 64 ? 2 : 1;
};

// Online softmax of one tile's scores in place: scale into the log2
// domain, mask (only on a tile on an edge of the warp's rows), update the
// running max m and this lane's share of the row sum l, and leave
// P = exp2(s - m) in s; returns each row's rescale factor in alpha.
// Rows: a (registers 4j, 4j + 1) and a + 8 (4j + 2, 4j + 3).
template <int BKV>
__device__ __forceinline__ void tc_softmax(float (&s)[BKV / 2], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           int k_lo, int r0, int row_a, int t,
                                           int Sk, int causal, int window,
                                           float scale_log2) {
  const bool edge = (causal && k_lo + BKV - 1 > r0) || k_lo + BKV > Sk ||
                    (window > 0 && k_lo + window <= r0 + 15);
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (edge) {
        const int qpos = row_a + (e >= 2 ? 8 : 0);
        const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        if (!keep) x = kNegInf;
      }
      s[4 * j + e] = x;
    }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2f(s[4 * j + e] - m[e / 2]);
      rs[e / 2] += s[4 * j + e];
    }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// P (fp32, in the accumulator's layout) as the bf16 A fragments of P V.
template <int BKV>
__device__ __forceinline__ void tc_pack_p(const float (&s)[BKV / 2],
                                          uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = mma::pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = mma::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// S (64 x BKV) = Q K^T for one KV tile, both operands K-major in shared
// memory, D / 16 steps.
template <int D>
__device__ __forceinline__ void tc_scores(float (&s)[TcTile<D>::BKV / 2],
                                          uint32_t q_addr, uint32_t k_addr) {
  using T = TcTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk * 16 / T::W, off = (kk * 16 % T::W) * 2;
    hopper::wgmma_ss<T::BKV, 0, 0>(
        s, hopper::desc(q_addr + blk * kTcBQ * T::SW + off, 16, 8 * T::SW, T::SW),
        hopper::desc(k_addr + blk * T::BKV * T::SW + off, 16, 8 * T::SW, T::SW),
        kk > 0);
  }
}

// O (64 x D) += P V for one KV tile: P from registers (BKV / 16 steps of
// 16 keys), V MN-major in shared memory, one wgmma per W columns of O.
template <int D>
__device__ __forceinline__ void tc_pv(
    float (&acc)[TcTile<D>::NB][TcTile<D>::W / 2],
    const uint32_t (&pa)[TcTile<D>::BKV / 16][4], uint32_t v_addr) {
  using T = TcTile<D>;
#pragma unroll
  for (int kk = 0; kk < T::BKV / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb)
      hopper::wgmma_rs<T::W, 1>(
          acc[nb], pa[kk],
          hopper::desc(v_addr + nb * T::BKV * T::SW + kk * 16 * T::SW,
                       T::BKV * T::SW, 8 * T::SW, T::SW),
          1);
}

// Barrier of the two warpgroups (id 1), of one (ids 2, 3); 0 is
// __syncthreads.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + grp) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, TcTile<D>::BLOCKS)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ o, int Sq, int Sk, int H, int Hkv,
                int causal, int window, float scale_log2) {
  using T = TcTile<D>;
  constexpr int BKV = T::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);
  // [group][stage][K, V], then the merge
  unsigned char* ring = base + T::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + T::RING);
  uint64_t* full = q_full + 1;             // [group][stage]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_lo = qt * kTcBQ;
  const int hk = h / (H / Hkv);
  // visible KV tiles of this query tile (the TPU kernel's pl.when test):
  // lo, lo + 1, ..., hi - 1, taken in turn by warpgroups 0 and 1
  const int n_tiles = (Sk + BKV - 1) / BKV;
  int hi = n_tiles;
  if (causal) hi = min(n_tiles, (q_lo + kTcBQ - 1) / BKV + 1);
  int lo = 0;
  if (window > 0 && q_lo - window + 1 > 0) lo = (q_lo - window + 1) / BKV;
  const int n_vis = max(hi - lo, 0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2 * kTcStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // the group as a value the compiler knows is the same across a warp
  const int grp = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wt = tid % 128, w = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q_lo + 16 * w;            // this warp's first row
  const int row_a = r0 + g;                // this lane's rows: a, a + 8
  const int n_mine = (n_vis - grp + 1) / 2;  // tiles grp, grp + 2, ...
  const uint32_t q_addr = hopper::smem_addr(qs);
  const uint32_t ring_addr = hopper::smem_addr(ring);
  // the group's j-th tile lies in its stage j % kTcStages
  auto stage = [&](int j) { return grp * kTcStages + j % kTcStages; };
  auto k_addr = [&](int j) {
    return ring_addr + stage(j) * 2 * T::KV_BYTES;
  };
  // one thread of the group loads its j-th tile, K and V, by TMA
  auto load = [&](int j) {
    const int st = stage(j);
    bf16* kst = reinterpret_cast<bf16*>(ring + st * 2 * T::KV_BYTES);
    bf16* vst = kst + BKV * D;
    const int row = (lo + grp + 2 * j) * BKV;
    hopper::mbar_expect_tx(&full[st], 2 * T::KV_BYTES);
    for (int cb = 0; cb < T::NB; ++cb) {
      hopper::tma_load_4d(kst + cb * BKV * T::W, &tm_k, &full[st],
                          cb * T::W, hk, row, b);
      hopper::tma_load_4d(vst + cb * BKV * T::W, &tm_v, &full[st],
                          cb * T::W, hk, row, b);
    }
  };
  if (tid == 0) {
    hopper::mbar_expect_tx(q_full, T::Q_BYTES);
    for (int cb = 0; cb < T::NB; ++cb)
      hopper::tma_load_4d(qs + cb * kTcBQ * T::W, &tm_q, q_full, cb * T::W,
                          h, q_lo, b);
  }
  if (wt == 0)
    for (int j = 0; j < kTcStages && j < n_mine; ++j) load(j);

  float acc[T::NB][T::W / 2];
#pragma unroll
  for (int nb = 0; nb < T::NB; ++nb)
#pragma unroll
    for (int c = 0; c < T::W / 2; ++c) acc[nb][c] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this lane's share of the row sum
  float s[BKV / 2], alpha[2];
  uint32_t pa[BKV / 16][4];              // P as the A fragments of P V

  // step j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}, runs the
  // softmax of S_j while the second product runs, refills the stage of
  // tile j - 1 with tile j - 1 + kTcStages, then rescales O once no
  // product is in flight
  hopper::mbar_wait(q_full, 0);
  if (n_mine > 0) {
    hopper::mbar_wait(&full[stage(0)], 0);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    tc_scores<D>(s, q_addr, k_addr(0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    tc_softmax<BKV>(s, m, l, alpha, (lo + grp) * BKV, r0, row_a, t, Sk,
                    causal, window, scale_log2);
    tc_pack_p<BKV>(s, pa);
  }
  for (int j = 1; j < n_mine; ++j) {
    hopper::mbar_wait(&full[stage(j)], (j / kTcStages) & 1);
    hopper::fence_regs(s);
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb) hopper::fence_regs(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) hopper::fence_regs(pa[kk]);
    hopper::wgmma_fence();
    tc_scores<D>(s, q_addr, k_addr(j));
    hopper::wgmma_commit();
    tc_pv<D>(acc, pa, k_addr(j - 1) + T::KV_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();             // S_j is done
    hopper::fence_regs(s);
    tc_softmax<BKV>(s, m, l, alpha, (lo + grp + 2 * j) * BKV, r0, row_a, t,
                    Sk, causal, window, scale_log2);
    hopper::wgmma_wait<0>();             // P V of tile j - 1 too
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb) hopper::fence_regs(acc[nb]);
    if (j - 1 + kTcStages < n_mine) {    // every warp is done with it
      group_sync(grp);
      if (wt == 0) load(j - 1 + kTcStages);
    }
    tc_pack_p<BKV>(s, pa);
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb)
#pragma unroll
      for (int c = 0; c < T::W / 8; ++c) {
        acc[nb][4 * c] *= alpha[0];
        acc[nb][4 * c + 1] *= alpha[0];
        acc[nb][4 * c + 2] *= alpha[1];
        acc[nb][4 * c + 3] *= alpha[1];
      }
  }
  if (n_mine > 0) {
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb) hopper::fence_regs(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) hopper::fence_regs(pa[kk]);
    hopper::wgmma_fence();
    tc_pv<D>(acc, pa, k_addr(n_mine - 1) + T::KV_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb) hopper::fence_regs(acc[nb]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // merge the two groups' softmax states: group 1 hands its fragments to
  // group 0 through the rings, idle once both are done
  float4* xfer = reinterpret_cast<float4*>(ring);
  consumers_sync();
  if (grp == 1) {
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb)
#pragma unroll
      for (int c = 0; c < T::W / 8; ++c)
        xfer[(nb * (T::W / 8) + c) * 128 + wt] =
            make_float4(acc[nb][4 * c], acc[nb][4 * c + 1],
                        acc[nb][4 * c + 2], acc[nb][4 * c + 3]);
    xfer[(D / 8) * 128 + wt] = make_float4(m[0], m[1], l[0], l[1]);
  }
  consumers_sync();
  if (grp == 0) {
    const float4 ml = xfer[(D / 8) * 128 + wt];
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
    for (int nb = 0; nb < T::NB; ++nb)
#pragma unroll
      for (int c = 0; c < T::W / 8; ++c) {
        const float4 x1 = xfer[(nb * (T::W / 8) + c) * 128 + wt];
        const int col = nb * T::W + 8 * c;
        if (row_a < Sq)
          *reinterpret_cast<uint32_t*>(orow_a + col) = mma::pack_bf16(
              (acc[nb][4 * c] * a0[0] + x1.x * a1[0]) * inv[0],
              (acc[nb][4 * c + 1] * a0[0] + x1.y * a1[0]) * inv[0]);
        if (row_a + 8 < Sq)
          *reinterpret_cast<uint32_t*>(orow_b + col) = mma::pack_bf16(
              (acc[nb][4 * c + 2] * a0[1] + x1.z * a1[1]) * inv[1],
              (acc[nb][4 * c + 3] * a0[1] + x1.w * a1[1]) * inv[1]);
      }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime (so the library
// needs no link to libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, S, heads, D) bf16 tensor as a 4-d tensor map whose box is `rows`
// positions of one head, W columns (one block of TcTile<D>) at a time.
template <int D>
bool tile_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int rows) {
  using T = TcTile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::W, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's shared-memory limit, set once per device.
template <int D>
cudaError_t tc_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TcTile<D>::SMEM);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int Hkv, int causal, int window,
              float scale, cudaStream_t stream) {
  const cudaError_t e = tc_attributes<D>();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  if (!tile_map<D>(&mq, q, B, Sq, H, kTcBQ) ||
      !tile_map<D>(&mk, k, B, Sk, Hkv, TcTile<D>::BKV) ||
      !tile_map<D>(&mv, v, B, Sk, Hkv, TcTile<D>::BKV))
    return kTensorMapError;
  const dim3 grid(H, B, (Sq + kTcBQ - 1) / kTcBQ);
  flash_tc_kernel<D><<<grid, kTcThreads, TcTile<D>::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), Sq, Sk, H, Hkv, causal, window,
      scale * kLog2e);
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

// Message of an error returned by the launch entry above: a cudaError_t,
// or kTensorMapError.
extern "C" const char* kernel_error_string(int err) {
  if (err == kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
