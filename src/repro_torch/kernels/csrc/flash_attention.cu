// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): causal / sliding-window GQA
// attention forward with an online softmax kept in fp32.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), out (B, Sq, H, D), all
// contiguous, fp32 or bf16; query head h reads KV head h / (H / Hkv).
//
// Design, the two tiled routes.  One block per (Q tile, head, batch):
// 64 rows on the tensor cores, 32 on the CUDA cores (two blocks a tile
// there).  The TPU kernel carries m/l/acc in VMEM scratch across a
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
// limits; every shape when forced): `flash_fwd_kernel`.  fp32 stays here
// because TF32 tensor cores (~1e-3) miss its 2e-5 tolerance, head dim 8
// because mma needs a depth of 16.  It carries every fp32 model check at
// full width, where a call is ~2 GFLOP (gemma3-1b's 1024 positions: 4
// heads x 524,800 visible pairs x 4 D flops), so it is bound by the fp32
// FMA rate (67 TFLOP/s, ~0.5 a SM) and by what feeds the FMAs: shared
// memory gives an SM 128 bytes a clock against its 128 FMAs a clock.  So:
//   * register tiles: a block is 32 query rows and 4 warps, each warp
//     owning 8 rows for both products.  S = Q K^T: lane (key group kg,
//     d lane sd) holds 8 rows x KPL keys (kg, kg + KG, ...) over its
//     slice of d, each 16-byte load of Q (a broadcast within the warp)
//     or of K feeding 8 or 4 * KPL FMAs; the SD partial sums of a key
//     then meet by a reduce-scatter of shuffles that leaves each lane
//     8 / SD rows.  O += P V: lane (row group, columns) holds 8 rows x
//     D / 32 columns of O (64 accumulators at D = 256); P comes from the
//     warp's own shared memory as a float4 of 4 keys (a broadcast), V as
//     float4s of a row (lanes on consecutive 16-byte chunks), so each V
//     load feeds 32 FMAs.  The softmax state of a row never leaves its
//     warp: alpha and l pass through 8 floats of the warp's memory;
//   * loads: Q and the K / V tiles by 16-byte cp.async into two stages;
//     tile j + 1 is issued right after the one block barrier of tile j,
//     so it lands while tile j is computed.  K rows are padded (32 bytes
//     when 4 key groups share a quarter warp, else 16) so that the lanes
//     of a quarter warp read distinct banks; rows past Sq or Sk are
//     zero-filled;
//   * schedule: 32-row query tiles, the last (heaviest under causal
//     masking) launched first; the two blocks of a cluster take the
//     tile's alternate KV tiles and merge at the end: each pushes its O
//     at the other's half of the columns and its m and l into the other's
//     shared memory (distributed shared memory, over the idle stages, one
//     cluster barrier before and one after), and each writes its half,
//     the two states weighed in block order.  So at gemma3-1b's check
//     (B = 1, 4 heads) 256 blocks fill the card two to an SM, and the
//     heaviest chain is 32 rows x 512 keys, a quarter of 64-row tiles in
//     one block; KV tiles of 32 rows (16 at D = 160 and 256), ~100 KB
//     of shared memory at D = 256, so two blocks share an SM;
//   * masking as before, by position against the true Sq and Sk with the
//     finite -0.7 FLT_MAX and the visible-tile bounds of causal and
//     window; bf16 (forced) is staged as bf16 and widened on each load.
// Attributes are set once per device.

// Tensor-core route (bf16, D = 16, 32, 64, 128, 160 or 256):
// `flash_tc_kernel`, built from Hopper's own parts (hopper.cuh) so the
// chain runs on the tensor cores with nothing else in its way.  A block
// is two warpgroups that take alternate KV tiles against the same 64-row
// Q tile (wgmma's M):
//   * loads: one thread loads the Q tile once, and one thread of each
//     warpgroup keeps that group's ring of three K/V stages full by TMA
//     (4-d tensor maps, one box of 64 KV rows, 32 at D = 160 and 256,
//     per 64 columns, 128/64/32-byte swizzled as wgmma reads them; at
//     D = 160, whose 64-column blocks would leave 32 over, five blocks
//     of 32 columns, 64-byte swizzled; a full mbarrier a stage),
//     refilling a stage once every warp of the group is done with it, so
//     no copy costs the group more than a few instructions.  There is
//     no producer warpgroup: ptxas gives every
//     thread of a block the launch bound's share of registers (168 with a
//     third warpgroup) whatever setmaxnreg grants later, and at D = 256
//     it then spilled and serialised the products; with two warpgroups a
//     thread may hold up to 255, and ptxas uses 182 at D = 256 (O alone
//     is 128 a thread), 130 at D = 160, 138 at D = 128 and 82-109 up to
//     D = 64, with no spill at any head dim;
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
// D = 256, 141 KB at D = 160); up to D = 64 two blocks share an SM.  The
// tensor maps are encoded on the host for each call (they hold the
// pointers), the kernel's attributes set once per device.
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
// four elements of T from shared memory (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 ld4f(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// ---------------------------------------------------------------------
// CUDA-core route: register tiles on the fp32 cores
// ---------------------------------------------------------------------
constexpr int kCcBQ = 32;                // query rows a block
constexpr int kCcSplit = 2;              // blocks (a cluster) a query tile
constexpr int kCcWarps = 4;              // each owns 8 of its rows
constexpr int kCcRows = kCcBQ / kCcWarps;
constexpr int kCcThreads = 32 * kCcWarps;

template <typename T, int D>
struct CcTile {
  // KV rows a tile: 32, and 16 above D = 128, so that two stages of K
  // and V and the Q tile stay near 100 KB and two blocks share an SM; at
  // D = 160 32 rows would fit two (107 KB in fp32) but take 220
  // registers a thread against 162, and measured 6-11% slower
  static constexpr int BKV = D > 128 ? 16 : 32;
  // scores: SD lanes split d (four elements a load), KG key groups; after
  // the sum over the SD lanes each lane keeps RPL rows x KPL keys
  static constexpr int SD = D / 4 < 8 ? D / 4 : 8;
  static constexpr int KG = 32 / SD;
  static constexpr int KPL = BKV / KG;
  static constexpr int RPL = kCcRows / SD;
  static constexpr int DPL = D / SD / 4;  // loads of d a lane per row
  // P V: LPR lanes across a row of O, PVG row groups of PVR rows, CPL
  // columns a lane (a multiple of 4: float4 runs LPR apart; else CPL
  // adjacent columns, as the 5 a lane at D = 160)
  static constexpr int LPR = D < 32 ? D : 32;
  static constexpr int PVG = 32 / LPR;
  static constexpr int PVR = kCcRows / PVG;
  static constexpr int CPL = D / LPR;
  // K rows are padded so that the lanes of a quarter warp (KG = 4: four
  // keys by two d offsets; else eight keys) read distinct banks
  static constexpr int KS = D + (KG == 4 ? 32 : 16) / (int)sizeof(T);
  static constexpr int PST = BKV + 4;    // P row stride (floats)
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements a cp.async
  static constexpr size_t Q_ELEMS = (size_t)kCcBQ * D;
  static constexpr size_t K_ELEMS = (size_t)BKV * KS;
  static constexpr size_t V_ELEMS = (size_t)BKV * D;
  // per warp: P (8 x PST), then 8 floats (alpha, at the end l) and 8 (m)
  static constexpr size_t P_FLOATS = (size_t)kCcRows * PST + 2 * kCcRows;
  static constexpr size_t SMEM =
      sizeof(T) * (Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS) +
      sizeof(float) * kCcWarps * P_FLOATS;
  static_assert(D % (4 * SD) == 0 && BKV % KG == 0 && KPL >= 1, "tiles");
  static_assert(kCcRows % SD == 0 && CPL >= 1, "lanes");
  // every column of Q K^T and of O has its lane: none is dropped
  static_assert(DPL * SD * 4 == D && CPL * LPR == D, "columns");
  static_assert((KS * sizeof(T)) % 16 == 0 && (D * sizeof(T)) % 16 == 0,
                "16-byte rows for cp.async");
  // after the tiles the partner's O at this block's columns (32 x D / 2)
  // and its m and l of each row land over the K / V stages
  static_assert(sizeof(T) * 2 * (K_ELEMS + V_ELEMS) >=
                    sizeof(float) * kCcBQ * (D / 2 + 2),
                "the partner's state fits the stages");
};

// Sum one half of R rows of partial scores with the lane `mask` apart:
// the lane with the mask bit set keeps the upper half, the other the
// lower, each adding its partner's share of the half it keeps.
template <int R, int KPL>
__device__ __forceinline__ void reduce_half(float (&s)[kCcRows][KPL],
                                            int mask, bool upper) {
#pragma unroll
  for (int r = 0; r < R / 2; ++r)
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float send = upper ? s[r][j] : s[r + R / 2][j];
      const float keep = upper ? s[r + R / 2][j] : s[r][j];
      s[r][j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

// CPL columns of one row of V (from shared memory) for lane column lc
template <typename T, int CPL, int LPR>
__device__ __forceinline__ void load_cols(const T* row, int lc,
                                          float (&v)[CPL]) {
  if constexpr (CPL % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CPL / 4; ++u) {
      const float4 x = ld4f(row + 4 * (lc + LPR * u));
      v[4 * u] = x.x;
      v[4 * u + 1] = x.y;
      v[4 * u + 2] = x.z;
      v[4 * u + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) v[c] = to_f32(row[CPL * lc + c]);
  }
}

// the column of O that a lane's c-th accumulator holds
template <int CPL, int LPR>
__device__ __forceinline__ int col_of(int lc, int c) {
  return CPL % 4 == 0 ? 4 * (lc + LPR * (c / 4)) + c % 4 : CPL * lc + c;
}

template <typename T, int D>
__global__ void __launch_bounds__(kCcThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Hkv, int causal, int window, float scale) {
  using C = CcTile<T, D>;
  constexpr int BKV = C::BKV, SD = C::SD, KG = C::KG, KPL = C::KPL;
  constexpr int RPL = C::RPL, PVR = C::PVR, CPL = C::CPL, LPR = C::LPR;
  constexpr int KS = C::KS, PST = C::PST, VEC = C::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                // 32 x D
  T* ks0 = qs + C::Q_ELEMS;                              // 2 x BKV x KS
  T* vs0 = ks0 + 2 * C::K_ELEMS;                         // 2 x BKV x D
  float* pw = reinterpret_cast<float*>(vs0 + 2 * C::V_ELEMS);

  // the two blocks of a cluster take alternate KV tiles of one query tile
  // and merge at the end; each writes half of the columns
  const int part = (int)hopper::cluster_rank();
  const int h = blockIdx.x / kCcSplit, b = blockIdx.y;
  // under causal masking the heaviest query tiles are launched first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_lo = qt * kCcBQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores: key group kg, d lanes sd; after the sum, rows sd RPL + i
  const int kg = lane % KG, sd = lane / KG;
  // P V: row group pg (rows pg PVR + i), column lane lc
  const int lc = lane % LPR, pg = lane / LPR;
  const int row0 = q_lo + warp * kCcRows;   // this warp's first row
  const T* qw = qs + warp * kCcRows * D;
  float* ps = pw + warp * C::P_FLOATS;      // this warp's P, then 16 floats
  float* aw = ps + kCcRows * PST;

  // visible KV tiles of this query tile (the TPU kernel's pl.when test)
  const int n_tiles = (Sk + BKV - 1) / BKV;
  int hi = n_tiles;
  if (causal) hi = min(n_tiles, (q_lo + kCcBQ - 1) / BKV + 1);
  int lo = 0;
  if (window > 0 && q_lo - window + 1 > 0) lo = (q_lo - window + 1) / BKV;
  // this block's tiles: lo + part, lo + part + 2, ...
  const int n_vis = max(hi - lo - part + 1, 0) / kCcSplit;

  // 16-byte cp.async copies of KV tile kt into stage st; rows past Sk are
  // zero-filled (0 * V must not meet stale bits)
  constexpr int CH = D / VEC;                // copies a row
  auto load_kv = [&](int kt, int st) {
    T* ks = ks0 + st * C::K_ELEMS;
    T* vs = vs0 + st * C::V_ELEMS;
    for (int i = tid; i < BKV * CH; i += kCcThreads) {
      const int r = i / CH, c = i % CH;
      const int s = kt * BKV + r;
      const bool ok = s < Sk;
      const size_t off =
          ((size_t)b * Sk + (ok ? s : 0)) * Hkv * D + (size_t)hk * D + c * VEC;
      mma::cp_async16(ks + r * KS + c * VEC, k + off, ok ? 16 : 0);
      mma::cp_async16(vs + r * D + c * VEC, v + off, ok ? 16 : 0);
    }
  };
  for (int i = tid; i < kCcBQ * CH; i += kCcThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = q_lo + r < Sq;
    const size_t off =
        ((size_t)b * Sq + (ok ? q_lo + r : 0)) * H * D + (size_t)h * D + c * VEC;
    mma::cp_async16(qs + r * D + c * VEC, q + off, ok ? 16 : 0);
  }
  if (n_vis > 0) load_kv(lo + part, 0);
  mma::cp_async_commit();

  float oacc[PVR][CPL];
#pragma unroll
  for (int i = 0; i < PVR; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) oacc[i][c] = 0.f;
  float m[RPL], l[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_vis; ++it) {
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1, whose stage the next copies refill
    mma::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_vis) load_kv(lo + part + kCcSplit * (it + 1), (it + 1) & 1);
    mma::cp_async_commit();
    const int k_lo = (lo + part + kCcSplit * it) * BKV;
    const T* ks = ks0 + (it & 1) * C::K_ELEMS;
    const T* vs = vs0 + (it & 1) * C::V_ELEMS;

    // S = Q K^T for the warp's 8 rows: this lane's keys kg + KG j against
    // its d slice (elements 4 (sd + SD u) .. + 3), 8 x KPL partial sums
    float s[kCcRows][KPL];
#pragma unroll
    for (int r = 0; r < kCcRows; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
#pragma unroll
    for (int u = 0; u < C::DPL; ++u) {
      const int d = 4 * (sd + SD * u);
      float4 q4[kCcRows];
#pragma unroll
      for (int r = 0; r < kCcRows; ++r) q4[r] = ld4f(qw + r * D + d);
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float4 k4 = ld4f(ks + (kg + KG * j) * KS + d);
#pragma unroll
        for (int r = 0; r < kCcRows; ++r) {
          s[r][j] = fmaf(q4[r].x, k4.x, s[r][j]);
          s[r][j] = fmaf(q4[r].y, k4.y, s[r][j]);
          s[r][j] = fmaf(q4[r].z, k4.z, s[r][j]);
          s[r][j] = fmaf(q4[r].w, k4.w, s[r][j]);
        }
      }
    }
    // sum over the SD lanes of a key group, each keeping RPL rows
    if constexpr (SD >= 2) reduce_half<8, KPL>(s, 16, lane & 16);
    if constexpr (SD >= 4) reduce_half<4, KPL>(s, 8, lane & 8);
    if constexpr (SD >= 8) reduce_half<2, KPL>(s, 4, lane & 4);

    // online softmax of rows sd RPL + i, masked by position
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int rl = sd * RPL + i;        // row within the warp
      const int qpos = row0 + rl;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kpos = k_lo + kg + KG * j;
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < KG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        ps[rl * PST + kg + KG * j] = p;
      }
#pragma unroll
      for (int off = 1; off < KG; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
      if (kg == 0) aw[rl] = alpha;
    }
    __syncwarp();                         // P and alpha, for the whole warp

    // O = alpha O + P V for rows pg PVR + i: 4 keys of P a load, CPL
    // columns of V a key
#pragma unroll
    for (int i = 0; i < PVR; ++i) {
      const float a = aw[pg * PVR + i];
#pragma unroll
      for (int c = 0; c < CPL; ++c) oacc[i][c] *= a;
    }
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 p4[PVR];
#pragma unroll
      for (int i = 0; i < PVR; ++i) p4[i] = ld4(ps + (pg * PVR + i) * PST + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPL];
        load_cols<T, CPL, LPR>(vs + (kk + u) * D, lc, vv);
#pragma unroll
        for (int i = 0; i < PVR; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y
                        : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CPL; ++c) oacc[i][c] = fmaf(p, vv[c], oacc[i][c]);
        }
      }
    }
    __syncwarp();                         // P is read before it is rewritten
  }
  mma::cp_async_wait<0>();                // Q's copies, where no tile ran

  // each row's l and m to the warp's shared floats; then, once both blocks
  // are done with their stages, each pushes its O at the partner's
  // columns and its m and l into the partner's stages, and merges its own
  // columns: O = (O_0 w_0 + O_1 w_1) / (l_0 w_0 + l_1 w_1), w_s =
  // exp(m_s - max m), in part order
  if (kg == 0)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      aw[sd * RPL + i] = l[i];
      aw[kCcRows + sd * RPL + i] = m[i];
    }
  __syncwarp();
  float* in_o = reinterpret_cast<float*>(ks0);       // 32 x D / 2
  float* in_ml = in_o + kCcBQ * (D / 2);              // 32 x (m, l)
  const int other = kCcSplit - 1 - part;
  hopper::cluster_sync();                 // both blocks' stages are free
#pragma unroll
  for (int i = 0; i < PVR; ++i) {
    const int rb = warp * kCcRows + pg * PVR + i;    // row in the tile
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = col_of<CPL, LPR>(lc, c);
      if (col / (D / 2) == other)
        hopper::peer_store(hopper::peer_addr(
            in_o + rb * (D / 2) + col - other * (D / 2), other), oacc[i][c]);
    }
  }
  if (kg == 0)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int rb = warp * kCcRows + sd * RPL + i;
      hopper::peer_store2(hopper::peer_addr(in_ml + 2 * rb, other),
                          make_float2(m[i], l[i]));
    }
  hopper::cluster_sync();                 // every push has landed
#pragma unroll
  for (int i = 0; i < PVR; ++i) {
    const int rl = pg * PVR + i;
    const int rb = warp * kCcRows + rl;
    const int qpos = row0 + rl;
    if (qpos >= Sq) continue;
    const float m_me = aw[kCcRows + rl], l_me = aw[rl];
    const float m_ot = in_ml[2 * rb], l_ot = in_ml[2 * rb + 1];
    const float mm = fmaxf(m_me, m_ot);
    const float w_me = expf(m_me - mm), w_ot = expf(m_ot - mm);
    // the parts' weights in part order, so both blocks sum alike
    const float w0 = part == 0 ? w_me : w_ot, w1 = part == 0 ? w_ot : w_me;
    const float l0 = part == 0 ? l_me : l_ot, l1 = part == 0 ? l_ot : l_me;
    const float inv = 1.f / fmaxf(l0 * w0 + l1 * w1, 1e-30f);
    T* orow = o + ((size_t)(b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = col_of<CPL, LPR>(lc, c);
      if (col / (D / 2) != part) continue;
      const float x_me = oacc[i][c];
      const float x_ot = in_o[rb * (D / 2) + col - part * (D / 2)];
      const float x = part == 0 ? x_me * w0 + x_ot * w1
                                : x_ot * w0 + x_me * w1;
      orow[col] = from_f32<T>(x * inv);
    }
  }
}

// The CUDA-core kernel's shared-memory limit, set once per device.
template <typename T, int D>
cudaError_t cc_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)CcTile<T, D>::SMEM);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const cudaError_t e = cc_attributes<T, D>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCcSplit * H, B, (Sq + kCcBQ - 1) / kCcBQ);
  cfg.blockDim = dim3(kCcThreads, 1, 1);
  cfg.dynamicSmemBytes = CcTile<T, D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCcSplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_fwd_kernel<T, D>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      Sq, Sk, H, Hkv, causal, window, scale);
  if (err != cudaSuccess) return (int)err;
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
    case 160: return launch<T, 160>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
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
  // KV rows a tile: 64, and 32 above D = 128 (six stages of 64 rows
  // would not fit the SM's shared memory at D = 160 or 256)
  static constexpr int BKV = D > 128 ? 32 : 64;
  // columns of a block: 64 where they divide D, else 32 (D = 160: five
  // blocks, 64-byte swizzled), else D (16)
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : D;
  static constexpr int NB = D / W;                // column blocks a row
  static_assert(NB * W == D && D % 16 == 0, "every column in a block");
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
    case 160: return launch_tc<160>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 256: return launch_tc<256>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    default: return -1;
  }
}

bool tc_takes(int dtype, int D) {
  return dtype == 1 && (D == 16 || D == 32 || D == 64 || D == 128 ||
                        D == 160 || D == 256);
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
// bf16.  route: 0 by shape (tensor cores for bf16 at every D but 8, the
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
