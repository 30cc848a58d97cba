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
// there); at D = 128 and 160 on the tensor cores one persistent block a
// SM walks tiles of 128 rows.  The TPU kernel carries m/l/acc in VMEM
// scratch across a sequential KV grid axis; here a loop inside the block
// walks the KV tiles instead, and it visits only the tiles that the
// causal and window masks leave visible, so masked work is skipped as on
// the TPU.
// Masking uses the finite constant -0.7 * FLT_MAX of the TPU kernel: a
// row whose first visible tile is fully masked for it accumulates
// exp(0) = 1 terms that the first real score wipes out with
// alpha = exp(NEG_INF - m) = 0, where -inf would give NaN.
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

// Tensor-core route (bf16, D = 16, 32, 64, 128, 160 or 256): built from
// Hopper's own parts (hopper.cuh) so the chain runs on the tensor cores
// with nothing else in its way.  Two kernels, each of two consumer
// warpgroups.
// `flash_tc_kernel` (D = 16, 32, 64 and 256): the groups take alternate
// KV tiles against the same 64-row Q tile (wgmma's M):
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
//     is 128 a thread) and 82-109 up to D = 64, with no spill at any
//     head dim;
//   * products: S = Q K^T by wgmma with both operands K-major in shared
//     memory, O += P V by wgmma with P from registers (the accumulator
//     rounded to bf16 in pairs) and V MN-major.  Step n issues S_n and
//     P_{n-1} V_{n-1} together, runs the softmax of S_n while the second
//     product runs, and rescales O once neither is in flight (so ptxas
//     never serialises the products); the other group's products fill
//     the tensor cores during this one's softmax.  At the end group 1
//     hands its (m, l, O) to group 0 through the idle rings and group 0
//     merges the two online softmaxes and writes O.
// `flash_tc_pair_kernel` (D = 160, stablelm-12b's prefill, and D = 128,
// llama3-8b's and minitron-8b's: 32 heads on 8).  Fitted to
// `flash_tc_kernel`, 160 columns meant five 32-column blocks, two rings
// of 32-row KV tiles (141 KB, one block a SM), twenty small wgmma a tile
// and the online softmax's rescale of O every 32 keys; it ran at 4.7x its
// bound and 1.5x SDPA.  At D = 128 it ran at 4.4x its bound and 1.6x
// SDPA: each K/V tile fed only 64 query rows, a consumer thread issued
// its group's copies, the groups took no turns, and its softmax kept
// exp2f and a predicated mask.  So a query tile is a pair of 64-row
// tiles, one a warpgroup, and both groups walk the same KV tiles:
//   * one ring of 64 KV rows a stage, three stages at D = 160 (40 KB of
//     K and V a stage), four at D = 128 (32 KB), each tile read from
//     shared memory by both groups' products; each group computes only
//     on the run of the tiles its own rows see (under causal masking
//     group 0 skips the last, with a window group 1 skips the first),
//     still releasing the others.  No state is merged: each
//     group writes its 64 rows;
//   * S = Q K^T is D / 16 wgmma m64n64k16 a tile; P V is one wgmma a
//     16-key step over all of V's boxes (MN-major, the descriptor's LBO
//     one box): m64n160k16 over five 32-column boxes (64-byte swizzled)
//     at D = 160, four a tile in place of twenty m64n32k16, and
//     m64n128k16 over two 64-column boxes (128-byte swizzled) at D = 128;
//     O is rescaled every 64 keys;
//   * a producer warp issues every TMA copy (Q, then the ring's tiles,
//     each once all eight consumer warps have arrived on its stage's empty
//     barrier): a consumer thread issuing a stage's ten copies held up its
//     warpgroup's next products.  Beside two warpgroups it caps ptxas at
//     168 registers a thread; the kernel needs 168 at D = 160 and 167 at
//     D = 128 without a spill;
//   * the groups take turns at the tensor cores (two named barriers): a
//     group issues S_r and P_{r-1} V_{r-1}, passes the turn, and runs the
//     softmax of S_r while the other group's products run; both groups
//     wait on the same tiles, and without turns they ran their softmaxes
//     at once with the tensor cores idle.  The turns also keep the groups
//     within a round of each other, which the empty barriers rely on: a
//     phase counts eight arrivals, and a group three tiles ahead (it
//     releases the tiles outside its run unread) would complete a stage's
//     phase with its own arrivals while the other group still reads it;
//   * the softmax is the chain that sets the pace (about half of a
//     steady round's cycles in tools/flash_pair_probe.py's trace):
//     ex2.approx in place of exp2f (5-11% of the kernel's time), the mask
//     as a branch of its own, and off the edge tiles the scale folded
//     into the exponent;
//   * O leaves through shared memory: each group writes its bf16 O into
//     its Q tile in the boxes' swizzle and one thread stores the boxes by
//     TMA, where scattered 4-byte stores from registers held the block's
//     end;
//   * persistent: one block a SM (Q double-buffered; 205 KB at D = 160,
//     198 KB at 128) walks query tiles heaviest first in a zig-zag
//     (block i takes tiles i, 2G - 1 - i, 2G + i, ...), so the next
//     tile's Q and KV tiles land while this one computes, group 0 starts
//     it while group 1 stores, and a block that took a heavy tile takes a
//     light one next; the ring and the turns run on across tiles.
// Both kernels keep the numbers of the mma.sync kernel they replaced:
// the log2-domain softmax on the fp32 accumulator (row max and sum across
// the 4 lanes of a row by two shuffles), P rounded to bf16, the mask
// applied only on tiles across an edge of a warp's 16 rows.  Rows past Sq
// or Sk arrive as zeros (TMA's out-of-bounds fill) and are masked by
// position.  Under causal masking the grid walks query tiles heaviest
// first.  Shared memory of `flash_tc_kernel`: the Q tile and the two
// rings (225 KB at D = 256); up to D = 64 two blocks share an SM.  The
// tensor maps are encoded on the host for each call (they hold the
// pointers), the kernels' attributes set once per device.
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

template <int D_>
struct TcTile {
  static constexpr int D = D_;
  // KV rows a tile: 64, and 32 above D = 128 (six stages of 64 rows
  // would not fit the SM's shared memory at D = 256)
  static constexpr int BKV = D > 128 ? 32 : 64;
  // columns of a block: 64 where they divide D, else D (16, 32)
  static constexpr int W = D % 64 == 0 ? 64 : D;
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
// memory (Q as 64-row column blocks, K as BKV-row ones), D / 16 steps.
template <typename T>
__device__ __forceinline__ void tc_scores(float (&s)[T::BKV / 2],
                                          uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < T::D / 16; ++kk) {
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
    tc_scores<T>(s, q_addr, k_addr(0));
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
    tc_scores<T>(s, q_addr, k_addr(j));
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

// ---------------------------------------------------------------------
// tensor-core route at D = 160: a pair of 64-row query tiles a block,
// one K/V ring for both warpgroups, fed by a producer warp
// ---------------------------------------------------------------------
constexpr int kPairBQ = 2 * kTcBQ;       // rows of a query tile: 64 a group
// two consumer warpgroups and one producer warp; ptxas sizes registers
// for the launch bound's threads (up to 168 a thread here)
constexpr int kPairThreads = kTcThreads + 32;
constexpr int kPairConsumerWarps = kTcThreads / 32;

template <int D_>
struct TcPair {
  static constexpr int D = D_;
  // 128 KV rows at D = 128 spilled 364 bytes and took 1.6x as long
  // (tools/flash_pair_probe.py's kv128: S and P of 128 keys beside O)
  static constexpr int BKV = 64;                  // KV rows a tile
  // columns a box: 32 (64-byte swizzle), five boxes at D = 160; 64
  // (128-byte swizzle), two boxes at D = 128, 1-3% faster there than
  // four of 32 (the probe's box64); P V reads them all in one wgmma, LBO
  // a box apart
  static constexpr int W = D == 128 ? 64 : 32;
  static constexpr int NB = D / W;
  static_assert(NB * W == D && D <= 256, "every column in a box; N <= 256");
  static constexpr int SW = 2 * W;                // swizzle bytes
  // K/V stages of the ring: at D = 160 three (two measured 30% slower at
  // B = 4, S = 512 in tools/flash_pair_probe.py; four do not fit beside
  // the two Q buffers); at D = 128 four, which fit and were 1-3.5%
  // faster than three
  static constexpr int STAGES = D == 128 ? 4 : 3;
  static constexpr int QG_BYTES = kTcBQ * D * 2;  // one group's Q (then O)
  static constexpr int Q_BYTES = 2 * QG_BYTES;    // a query tile's Q
  static constexpr int KV_BYTES = BKV * D * 2;    // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // alignment slack, two query tiles' Q, the ring, then the barriers: each
  // Q buffer's full and empty, each stage's full and empty
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + 8 * (4 + 2 * STAGES);
  static_assert(SMEM <= 232448, "one block's shared memory on an H100");
};

// The KV tiles of BKV rows that query rows [r_lo, r_hi) see (the TPU
// kernel's pl.when test), as [x, y); empty where no row is below Sq.
__device__ __forceinline__ int2 tc_visible(int r_lo, int r_hi, int Sq,
                                           int Sk, int bkv, int causal,
                                           int window) {
  r_hi = min(r_hi, Sq);
  if (r_lo >= r_hi) return make_int2(0, 0);
  const int n_tiles = (Sk + bkv - 1) / bkv;
  int hi = n_tiles;
  if (causal) hi = min(n_tiles, (r_hi - 1) / bkv + 1);
  int lo = 0;
  if (window > 0 && r_lo - window + 1 > 0) lo = (r_lo - window + 1) / bkv;
  return make_int2(lo, max(lo, hi));
}

// O (64 x D) += P V for one KV tile: P from registers (BKV / 16 steps of
// 16 keys), V MN-major in shared memory as NB column boxes, all D
// columns in one wgmma a step.
template <typename T>
__device__ __forceinline__ void tc_pv_wide(float (&acc)[T::D / 2],
                                           const uint32_t (&pa)[T::BKV / 16][4],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < T::BKV / 16; ++kk)
    hopper::wgmma_rs<T::D, 1>(
        acc, pa[kk],
        hopper::desc(v_addr + kk * 16 * T::SW, T::BKV * T::SW, 8 * T::SW,
                     T::SW),
        1);
}

// 2^x by the hardware's ex2.approx.ftz (about 2 ulp; results below 2^-126
// flush to 0, far below what a bf16 P keeps).  With exp2f the kernel
// takes 5-11% longer (tools/flash_pair_probe.py, H100).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tc_softmax's online softmax for the pair kernel, in fewer instructions:
// the mask is a branch of its own (as a predicate inside the unrolled
// loop every tile paid for its instructions), and off the edge
// tiles, where every score is finite, the scale folds into the exponent,
// 2^(s * scale - m) in one FFMA, with m the scaled row max.  An edge tile
// scales, masks to -0.7 FLT_MAX and subtracts as tc_softmax does (a
// folded exponent of a masked score would be off by the product's
// rounding, ~1e30).
template <int BKV>
__device__ __forceinline__ void pair_softmax(float (&s)[BKV / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k_lo,
                                             int r0, int row_a, int t, int Sk,
                                             int causal, int window,
                                             float scale_log2) {
  const bool edge = (causal && k_lo + BKV - 1 > r0) || k_lo + BKV > Sk ||
                    (window > 0 && k_lo + window <= r0 + 15);
  float mx[2] = {kNegInf, kNegInf};
  float rs[2] = {0.f, 0.f};
  if (edge) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row_a + (e >= 2 ? 8 : 0);
        const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        const float x = keep ? s[4 * j + e] * scale_log2 : kNegInf;
        s[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(s[4 * j + e] - m[e / 2]);
        rs[e / 2] += s[4 * j + e];
      }
  } else {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
    float nm[2];                         // -m, scaled
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      nm[r] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, nm[e / 2]));
        rs[e / 2] += s[4 * j + e];
      }
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// The two groups' turns at the tensor cores (barriers 4 and 5, of both
// groups' 256 threads): a group waits for its turn before it issues its
// products and passes the turn on once they are issued, so one group's
// products run during the other's softmax.
__device__ __forceinline__ void turn_wait(int grp) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(4 + grp) : "memory");
}
__device__ __forceinline__ void turn_pass(int grp) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(5 - grp) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_tc_pair_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, int B, int Sq,
                     int Sk, int H, int Hkv, int causal, int window,
                     float scale_log2) {
  using T = TcPair<D>;
  constexpr int BKV = T::BKV, ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  // two Q buffers, [buffer][group][box][64 rows][W]: a query tile's Q,
  // then its O for the store, while the next tile's Q lands in the other
  unsigned char* qs = base;
  unsigned char* ring = base + 2 * T::Q_BYTES;  // [stage][K, V][box][BKV][W]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + ST * T::STAGE_BYTES);
  uint64_t* q_empty = q_full + 2;            // a buffer's: both groups done
  uint64_t* full = q_empty + 2;              // a stage's: its tile landed
  uint64_t* empty = full + ST;               // a stage's: every warp is done

  // items, heaviest first under causal masking (the last query tile of
  // every (b, h) first); the block's n-th is item n G + blockIdx.x for
  // even n and n G + G - 1 - blockIdx.x for odd n (G blocks), so a block
  // that took one of the heaviest takes one of the lightest next
  const int n_qt = (Sq + kPairBQ - 1) / kPairBQ;
  const int n_items = n_qt * H * B;
  const int G = gridDim.x;
  auto nth = [&](int n) {
    return n * G + (n % 2 ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  struct Item {
    int h, b, q_lo, lo, n_vis;
  };
  auto item_of = [&](int i) {
    Item it;
    const int z = i / (H * B), hb = i % (H * B);
    it.b = hb / H;
    it.h = hb % H;
    it.q_lo = (causal ? n_qt - 1 - z : z) * kPairBQ;
    const int2 vis = tc_visible(it.q_lo, it.q_lo + kPairBQ, Sq, Sk, BKV,
                                causal, window);
    it.lo = vis.x;
    it.n_vis = vis.y - vis.x;
    return it;
  };
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      hopper::mbar_init(&q_full[qb], 1);
      hopper::mbar_init(&q_empty[qb], 2);
    }
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kPairConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTcThreads) {
    // the producer warp: one thread issues every copy, for each query tile
    // its Q (once both groups have stored the O of the tile two before from
    // that buffer) and then its KV tiles through the ring, each once every
    // consumer warp has released the tile ST before it
    if (tid == kTcThreads) {
      int jg = 0;                            // tiles through the ring so far
      for (int n = 0, i = nth(0); i < n_items; i = nth(++n)) {
        const Item it = item_of(i);
        const int hk = it.h / (H / Hkv), qb = n % 2;
        if (n >= 2) hopper::mbar_wait(&q_empty[qb], (n / 2 - 1) & 1);
        const bool two = it.q_lo + kTcBQ < Sq;  // group 1 has a row below Sq
        unsigned char* qd = qs + qb * T::Q_BYTES;
        hopper::mbar_expect_tx(&q_full[qb], (two ? 2 : 1) * T::QG_BYTES);
        for (int gq = 0; gq < (two ? 2 : 1); ++gq)
          for (int cb = 0; cb < T::NB; ++cb)
            hopper::tma_load_4d(qd + (gq * T::NB + cb) * kTcBQ * T::SW, &tm_q,
                                &q_full[qb], cb * T::W, it.h,
                                it.q_lo + kTcBQ * gq, it.b);
        for (int j = 0; j < it.n_vis; ++j, ++jg) {
          const int st = jg % ST;
          if (jg >= ST) hopper::mbar_wait(&empty[st], (jg / ST - 1) & 1);
          unsigned char* kst = ring + st * T::STAGE_BYTES;
          unsigned char* vst = kst + T::KV_BYTES;
          hopper::mbar_expect_tx(&full[st], T::STAGE_BYTES);
          for (int cb = 0; cb < T::NB; ++cb) {
            hopper::tma_load_4d(kst + cb * BKV * T::SW, &tm_k, &full[st],
                                cb * T::W, hk, (it.lo + j) * BKV, it.b);
            hopper::tma_load_4d(vst + cb * BKV * T::SW, &tm_v, &full[st],
                                cb * T::W, hk, (it.lo + j) * BKV, it.b);
          }
        }
      }
    }
    return;
  }

  // the group as a value the compiler knows is the same across a warp
  const int grp = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wt = tid % 128, w = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t ring_addr = hopper::smem_addr(ring);
  if (grp == 1) turn_pass(grp);          // group 0's first turn
  int jg0 = 0;                           // ring tiles of earlier query tiles
  for (int n = 0, i = nth(0); i < n_items; i = nth(++n)) {
    const Item it = item_of(i);
    const int lo = it.lo, n_vis = it.n_vis, qb = n % 2;
    const int g_lo = it.q_lo + kTcBQ * grp;  // this group's first row
    const int r0 = g_lo + 16 * w;            // this warp's first row
    const int row_a = r0 + g;                // this lane's rows: a, a + 8
    // this group's run: the query tile's ring tiles a, a + 1, ..., e - 1
    const int2 own = tc_visible(g_lo, g_lo + kTcBQ, Sq, Sk, BKV, causal,
                                window);
    const int a = own.x - lo, e = own.y - lo;
    unsigned char* qg = qs + qb * T::Q_BYTES + grp * T::QG_BYTES;
    const uint32_t q_addr = hopper::smem_addr(qg);
    // tile r of this query tile is the ring's tile jg0 + r: stage
    // (st0 + r) % ST of phase ph0 + (st0 + r) / ST
    const int st0 = jg0 % ST, ph0 = jg0 / ST;
    auto k_addr = [&](int r) {
      return ring_addr + ((st0 + r) % ST) * T::STAGE_BYTES;
    };
    auto wait_tile = [&](int r) {
      hopper::mbar_wait(&full[(st0 + r) % ST], (ph0 + (st0 + r) / ST) & 1);
    };
    // this warp is done with tile r (or never reads it)
    auto release = [&](int r) {
      if (lane == 0) hopper::mbar_arrive(&empty[(st0 + r) % ST]);
    };
    // the groups take turns in rounds 0..n_vis (group 0 first): in round r
    // a group issues S_r if tile r is in its run and P_{r-1} V_{r-1} if
    // tile r - 1 is, then releases tile r - 1; group 1's pass after its
    // last round is group 0's first turn of the next query tile (none
    // after the block's last), so every wait has its pass and group 0
    // starts the next tile while group 1 stores this one
    const bool more = nth(n + 1) < n_items;
    auto pass = [&](int r) {
      if (grp == 0 || r < n_vis || more) turn_pass(grp);
    };
    auto idle = [&](int r) {                 // a round with no product
      turn_wait(grp);
      pass(r);
      if (r > 0) release(r - 1);
    };
    float acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};             // this lane's share of the row sum
    float s[BKV / 2], alpha[2];
    uint32_t pa[BKV / 16][4];            // P as the A fragments of P V

    if (e <= a) {
      for (int r = 0; r <= n_vis; ++r) idle(r);
    } else {
      for (int r = 0; r < a; ++r) idle(r);
      // round a: S_a alone
      hopper::mbar_wait(&q_full[qb], (n / 2) & 1);
      wait_tile(a);
      turn_wait(grp);
      hopper::fence_regs(s);
      hopper::wgmma_fence();
      tc_scores<T>(s, q_addr, k_addr(a));
      hopper::wgmma_commit();
      pass(a);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      pair_softmax<BKV>(s, m, l, alpha, (lo + a) * BKV, r0, row_a, t, Sk,
                        causal, window, scale_log2);
      if (a > 0) release(a - 1);
      tc_pack_p<BKV>(s, pa);
      // rounds a + 1 .. e - 1: S_r with P_{r-1} V_{r-1}; the softmax of
      // S_r runs while this group's P V and the other group's products
      // run, and O is rescaled once no product of this group is in flight
      for (int r = a + 1; r < e; ++r) {
        wait_tile(r);
        turn_wait(grp);
        hopper::fence_regs(s);
        hopper::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) hopper::fence_regs(pa[kk]);
        hopper::wgmma_fence();
        tc_scores<T>(s, q_addr, k_addr(r));
        hopper::wgmma_commit();
        tc_pv_wide<T>(acc, pa, k_addr(r - 1) + T::KV_BYTES);
        hopper::wgmma_commit();
        pass(r);
        hopper::wgmma_wait<1>();         // S_r is done
        hopper::fence_regs(s);
        pair_softmax<BKV>(s, m, l, alpha, (lo + r) * BKV, r0, row_a, t, Sk,
                          causal, window, scale_log2);
        hopper::wgmma_wait<0>();         // P V of tile r - 1 too
        hopper::fence_regs(acc);
        release(r - 1);
        tc_pack_p<BKV>(s, pa);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c] *= alpha[0];
          acc[4 * c + 1] *= alpha[0];
          acc[4 * c + 2] *= alpha[1];
          acc[4 * c + 3] *= alpha[1];
        }
      }
      // round e: P_{e-1} V_{e-1} alone
      turn_wait(grp);
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) hopper::fence_regs(pa[kk]);
      hopper::wgmma_fence();
      tc_pv_wide<T>(acc, pa, k_addr(e - 1) + T::KV_BYTES);
      hopper::wgmma_commit();
      pass(e);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(e - 1);
      for (int r = e + 1; r <= n_vis; ++r) idle(r);
    }
    jg0 += n_vis;

    // O / l in bf16 into this group's Q tile (its products are done), in
    // the swizzle of the boxes; then one thread stores each box by TMA
    // (rows past Sq are not written) and, once the store has read the
    // buffer, hands it back to the producer.  No state to merge.
    if (g_lo < Sq) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv[2] = {1.f / fmaxf(l[0], 1e-30f),
                            1.f / fmaxf(l[1], 1e-30f)};
      constexpr int CPB = T::W / 8;          // 16-byte chunks a box row
      const int ra = 16 * w + g;             // row a within the tile
      // its chunks' swizzle (hopper.cuh's o ^ ((o >> 3) & (SW - 16)) on
      // the row's offset), the same for row a + 8
      const int sw = ((ra * T::SW) >> 7) & (CPB - 1);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        unsigned char* p = qg + (c / CPB) * kTcBQ * T::SW + ra * T::SW +
                           (((c % CPB) ^ sw) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(p) =
            mma::pack_bf16(acc[4 * c] * inv[0], acc[4 * c + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(p + 8 * T::SW) =
            mma::pack_bf16(acc[4 * c + 2] * inv[1], acc[4 * c + 3] * inv[1]);
      }
      hopper::fence_proxy_async();
      group_sync(grp);
      if (wt == 0) {
        for (int cb = 0; cb < T::NB; ++cb)
          hopper::tma_store_4d(&tm_o, qg + cb * kTcBQ * T::SW, cb * T::W, it.h,
                               g_lo, it.b);
        hopper::bulk_commit();
        hopper::bulk_wait_read();
      }
    }
    if (wt == 0) hopper::mbar_arrive(&q_empty[qb]);
  }
}

// SMs of the current device, asked once per device.
int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && counts[dev].load(std::memory_order_acquire) > 0)
    return counts[dev].load(std::memory_order_acquire);
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) counts[dev].store(n, std::memory_order_release);
  return n;
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
// positions of one head, W columns (one column block of tile T) at a time.
template <typename T>
bool tile_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int rows) {
  constexpr int D = T::D;
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
  if (!tile_map<TcTile<D>>(&mq, q, B, Sq, H, kTcBQ) ||
      !tile_map<TcTile<D>>(&mk, k, B, Sk, Hkv, TcTile<D>::BKV) ||
      !tile_map<TcTile<D>>(&mv, v, B, Sk, Hkv, TcTile<D>::BKV))
    return kTensorMapError;
  const dim3 grid(H, B, (Sq + kTcBQ - 1) / kTcBQ);
  flash_tc_kernel<D><<<grid, kTcThreads, TcTile<D>::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), Sq, Sk, H, Hkv, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// The pair kernel's shared-memory limit, set once per device.
template <int D>
cudaError_t pair_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_tc_pair_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TcPair<D>::SMEM);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int D>
int launch_tc_pair(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  using T = TcPair<D>;
  const cudaError_t e = pair_attributes<D>();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo;
  if (!tile_map<T>(&mq, q, B, Sq, H, kTcBQ) ||
      !tile_map<T>(&mk, k, B, Sk, Hkv, T::BKV) ||
      !tile_map<T>(&mv, v, B, Sk, Hkv, T::BKV) ||
      !tile_map<T>(&mo, o, B, Sq, H, kTcBQ))
    return kTensorMapError;
  // one block a SM (the block's shared memory allows no second), each
  // walking query tiles blockIdx.x, + gridDim.x, ...
  const int items = ((Sq + kPairBQ - 1) / kPairBQ) * H * B;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = items < sms ? items : sms;
  if (grid == 0) return 0;
  flash_tc_pair_kernel<D><<<grid, kPairThreads, T::SMEM, stream>>>(
      mq, mk, mv, mo, B, Sq, Sk, H, Hkv, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int dispatch_tc(int D, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int Hkv, int causal,
                int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 32: return launch_tc<32>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 64: return launch_tc<64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 128: return launch_tc_pair<128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
    case 160: return launch_tc_pair<160>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
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
