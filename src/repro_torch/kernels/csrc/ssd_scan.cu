// Mamba2 chunked SSD scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (`ssd_scan`,
// body `_ssd_kernel`): x (B, S, H, P), dt (B, S, H) fp32, a_log (H,)
// fp32, B/C (B, S, G, N); y (B, S, H, P) in x's dtype.  Per chunk of Q
// steps, with cs the inclusive cumsum of dt * A (A = -exp(a_log)):
//
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra)
//        + exp(cs_i) C_i . h_prev                               (inter)
//   h    = exp(cs_end) h_prev + sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j
//
// and the state h (P, N) carries to the next chunk.  This kernel also
// writes the final state (B, H, P, N) fp32, which the TPU kernel keeps in
// scratch and drops: prefill stores it in the decode cache.
//
// What bounds it on an H100.  At mamba2-130m's serving shapes (B = 4,
// S = 512, H = 24, P = 64, G = 1, N = 128, Q = 64) one call moves ~17 MB
// in bf16 (x, y, B, C, dt and the fp32 state: ~5 us at 3.35 TB/s) and
// ~31 MB in fp32 (~9 us).  Per (b, h, chunk) it needs Q (Q + 1) N flops
// for the causal triangle of the scores C B^T, Q (Q + 1) P for M x,
// 2 Q N P for the chunk's state and 2 Q N P for C h_in^T (not on the
// first chunk, whose h_in is zero): 2.1 GFLOP, ~32 us on the fp32 CUDA
// cores (67 TFLOP/s), ~2 us on the bf16 tensor cores, so in bf16 the
// card's bound is the bytes.  B and C are read per group (g = h / (H /
// G)) straight from the (B, S, G, N) input, so the G -> H repeat the TPU
// wrapper makes is never materialised.  The cumsum of dt * A is taken in
// fp64 in each block that needs it (warp 0: each lane sums a run, one
// warp scan adds the runs' offsets): the decays exp(cs_i - cs_j) take the
// difference of two cumulative sums that reach a few hundred over a
// chunk, and in fp32 that difference alone loses ~1e-5 of relative
// precision.
//
// Two routes, chosen by dtype and shape before the launch (never after a
// failure): `ssd_scan_fwd`'s `route` argument is 0 (by shape), 1 (CUDA
// cores) or 2 (tensor cores), and it returns -1 where a forced route
// cannot take the shape.
//
// Tensor-core route (bf16; P, N, Q multiples of 16, Q <= 128): one
// launch, `ssd_cluster_kernel`.  The TPU kernel walks the chunks of one
// (b, h) in order and keeps the (P, N) state in VMEM.  Here the C blocks
// of a thread-block cluster (C in 1, 2, 4, 8) take one (batch row, head),
// rank r the chunks r, r + C, ..., one a round, and the state never
// leaves the chip between chunks: it passes through the cluster's
// distributed shared memory.  A is a scalar per head, so the recurrence
// h_c = exp(cs_end,c) h_{c-1} + dS_c runs apart for each of the P N state
// elements: once the round's chunks have their dS_c, the ranks split the
// state by rows and each walks its rows over the round's chunks alone.
// Per round:
//   1. each rank with a chunk loads dt, then C, B and x by 16-byte
//      cp.async, and takes the cumsum, w_j = dt_j exp(cs_end - cs_j) and
//      exp(cs);
//   2. dS_c = (x o w)^T B by mma.sync (x o w formed as a bf16 pair from
//      x's fragment), each accumulator fragment pushed (st.shared::cluster,
//      16 bytes a push: neighbouring lanes swap halves) to the rank that
//      walks its rows, exp(cs_end) to every rank; then the scores C B^T and
//      the masked M = C B^T o L o dt into registers (branch-free:
//      a masked decay is exp(-inf), so the elements' exp chains overlap);
//   3. arrive on the cluster barrier (release); y = M x meanwhile; wait
//      (acquire): the round's increments have landed;
//   4. each rank walks its rows, h = exp(cs_end,c) h + dS_c in fp32 from
//      the carry the last round left it, and pushes the state entering
//      each chunk, as a bf16 pair, into the chunk owner's h_in (over B,
//      dead since the scores; 16 bytes a push: a lane pair covers 8
//      columns, one lane pushing their hi, the other their lo); the last
//      round writes the final state;
//   5. one more cluster barrier; y += exp(cs) o (C h_in^T), written once.
// So a round costs two cluster barriers, and every hand-off is a push
// that nobody waits on until the barrier.  The three passes this kernel
// replaced wrote every chunk's dS and h_in to global
// workspaces and read them back (~25 MB at B = 4) over three launches; a
// one-launch chain that handed the state from chunk to chunk through L2
// lost at B = 1 to its eight serial hand-offs (PERF.md, 6).
// Tiles.  Steps 2-5 run per tile of the state, rows outer: y's columns
// of a row tile stay in a warp's registers across the barriers (2
// column pairs a warp at Q <= 64, 5 above, so row tiles of at most 64 and
// 80 rows: `cl_tiles`), and where the block would not fit an SM with the
// whole state's increments and h_in, columns are tiled too (the fewest
// tiles that fit with a carry at a cluster of 8; B then keeps its own
// buffer, since every tile reads it).  Each tile costs its two barriers;
// at mamba2-130m's widths the state is one tile, and a one-tile shape
// runs an instance whose tile loops run once by constant bounds (with
// them, the Q = 64 instance spills past the 128 registers of two blocks
// a SM).  So every shape the route takes (multiples of 16, Q <= 128,
// some tiling that fits) runs on this kernel: P = 128 takes two row
// tiles, N = 512 two column tiles at P = 64.
// Occupancy.  At mamba2-130m's widths the block takes 97,568 bytes of
// shared memory (x; C; B, then h_in's pair over it; the round's fp32
// increments, P rows padded by 8 floats so the pushes hit distinct
// banks), so two fit an SM.  The cluster size: of 1, 2, 4 and 8 (at most
// the chunks rounded up to a power of two), the one with the fewest waves
// times rounds, the smaller on a tie, among those whose block with its
// carry (the state of a rank's rows between rounds, P / C x N fp32) fits
// an SM.  Waves are the (batch row, head) clusters over those the card
// holds at once (cudaOccupancyMaxActiveClusters, asked once per device and
// shape): a wave repeats the whole walk, a round only one chunk's.  On
// an H100 that is 8 / 4 / 2 at B = 1 / 2 / 4 (24, 48, 96 clusters; 30
// clusters of 8 held at once).  8 and 4 were the fastest at B = 1 and 2;
// at B = 4, where 2, 4 and 8 tie, 8 was ~2% faster than the 2 the rule
// takes, and the same tie goes to 4 at B = 2, where 8 lost ~10%.  A
// rank past the round's last chunk only walks and pushes.  The shared
// memory attribute is set once per device; a refused cluster launch
// returns its cudaError_t.
// What bounds it now.  At B = 1 a block's chain, not the bytes: per round
// the loads, the increments and their pushes, the slab of 16 rows with
// the most keys (scores, M, M x), the walk, the barriers and C h_in^T run
// one after another at 8 warps a block.
// Precision.  x, B and C are bf16 already and enter the products
// exactly.  The three operands the kernel computes (x o w, the masked
// scores, h_in) are each carried as a pair of bf16 values, hi = bf16(v)
// and lo = bf16(v - hi), and the product runs once per half: with a
// single bf16 rounding (8-bit mantissa) y misses the 2e-2 tolerance at
// mamba2-130m's widths in a CPU model of these steps (tests/test_torch_
// tensor_core.py, which also holds the sliced exchange to the passes bit
// for bit), fp16 (10 bits) would turn bf16 inputs above 65504 into inf,
// and the pair (16 bits) stays near the error of exact products (rounding
// y to bf16).  The state chain is fp32, one fma a step.
//
// CUDA-core route (fp32, and bf16 shapes the tensor cores refuse, such
// as P = 8; P, N and Q multiples of 4): three passes on the CUDA cores,
// with fp32 workspaces, every chunk a block:
//   1. `ssd_cc_state_kernel`, one block per (b, h, chunk): the cumsum,
//      then dS_c = (x o w)^T B (P x N) in fp32, each thread a 4 x 4 tile
//      over the chunk's Q steps, written with cs_end to fp32 workspaces
//      (~49 KB of shared memory at mamba2-130m's widths);
//   2. `ssd_state_pass_kernel`, one thread per (b, h, p, 4 n): the state
//      chain over the chunks in fp32, writing the state entering each
//      chunk and the final state;
//   3. `ssd_cc_scan_kernel`, one block per (b, h, chunk): the scores
//      C B^T on the FP64 tensor cores (mma.sync m8n8k4, each warp a
//      16 x 16 piece of the lower triangle; operands converted from the
//      fp32 copies as each fragment is read), the masked decayed matrix
//      M = C B^T o L o dt rounded once to fp32 in shared memory, then
//      y = M x + exp(cs) o (C h_in^T) in fp32, each thread 4 rows x 4
//      columns of y (columns p, p + P/4, ... so the lanes' reads of h_in
//      rows hit distinct banks), the C h_in^T sum in two interleaved
//      chains of n.  h_in lands (cp.async) over B's copy while M x runs.
//      100 KB of shared memory at mamba2-130m's widths and at most 128
//      registers a thread: two blocks a SM (`ssd_scan_blocks_per_sm`, the
//      CUDA occupancy calculator, on an H100).
// Precision.  In a CPU model of these passes (tests/test_torch_ssd_fp32_
// passes.py) at mamba2-130m's serving shape (B = 4, S = 512), against the
// recurrence in fp64 with atol = rtol = 2e-5, the scores are where fp32
// falls short: summed as one fp32 chain over N = 128 they take y to 1.30
// of the tolerance on that test's inputs, in fp64 to 0.36.  M, M x, the
// decays (fp64 differences, fp32 exp), dS and the state stay fp32; the
// C h_in^T sum runs as two chains (even and odd n), which shortens each
// chain of roundings.  So only the scores (0.4 of the call's 2.1 GFLOP)
// are fp64, on the 67 TFLOP/s FP64 tensor cores; the fp32 work (1.7
// GFLOP, ~26 us) sets the bound.  The fp32 -> fp64 conversions (16 a
// clock on an SM, a quarter of the FP64 rate) are the price of keeping
// the operands fp32 in shared memory, which holds two blocks a SM.
// Where the time goes: the chunk scan takes more than half of it, the
// chunk states about a quarter, and the state pass moves dS and h_in
// (~47 MB at B = 4) at about the HBM rate.  The 4 x 4 register tiles of
// the two block passes read 16 bytes of shared memory for every 8 FMAs,
// which caps them near half the fp32 rate: larger tiles, or the fp32
// products on the tensor cores in split precision, come next.

#include <algorithm>
#include <array>
#include <atomic>
#include <mutex>
#include <type_traits>
#include <vector>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

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
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void unpack(float4 v, float (&o)[4]) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

using bf16 = __nv_bfloat16;
constexpr int kTcMaxQ = 128;
constexpr int kPassThreads = 256;        // the CUDA cores' state pass

// Inclusive cumsum of dt * A over one chunk into cs (fp64), by warp 0:
// each lane sums a run of ceil(Q/32) steps, then one warp scan of the run
// totals gives every run its offset.
__device__ __forceinline__ void chunk_cumsum(double* cs, const float* dts,
                                             float A, int Q, int tid) {
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(tid * per, Q), hi = min(lo + per, Q);
  double run = 0.0;
  for (int j = lo; j < hi; ++j) {
    run += (double)(dts[j] * A);   // the fp32 dA the recurrence uses
    cs[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += v;
  }
  const double offset = incl - run;
  for (int j = lo; j < hi; ++j) cs[j] += offset;
}

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi), two values a pair.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = mma::pack_bf16(a - back.x, b - back.y);
}

// ---------------------------------------------------------------------
// tensor-core route (bf16): one cluster launch
// ---------------------------------------------------------------------
constexpr int kCluster = 8;              // the largest cluster size
constexpr size_t kMaxSmem = 232448;      // an H100 block's most, 227 KB

template <int QT>
__host__ __device__ constexpr int scan_halves() { return QT <= 4 ? 2 : 1; }
// The cluster kernel's threads: two warps per 16-row slab of the chunk
// that split y's columns (one for Q > 64, to stay within the registers).
template <int QT>
__host__ __device__ constexpr int cl_threads() {
  return 32 * QT * scan_halves<QT>();
}
// 16-column pairs of y a warp holds in registers across the exchange (2
// at Q <= 64, within the 128 registers of two blocks a SM; 5 above), so
// the 16-row pieces of a tile of the state: those of a slab's warps.
__host__ __device__ constexpr int cl_pairs(int QT) { return QT <= 4 ? 2 : 5; }
__host__ __device__ constexpr int cl_tile_pieces(int QT) {
  return QT <= 4 ? 2 * cl_pairs(QT) : cl_pairs(QT);
}

// The cluster kernel's shared memory at (P, N, Q, cluster C), with the
// carry of a rank's rows where the chunks take more than one round, for
// state tiles of PB rows x NB columns.  Rows of bf16 tiles are padded by
// 8 elements, those of the fp32 state increments by 8 floats, so the
// fragments' reads and the peers' pushes hit distinct banks.
struct ClSmem {
  size_t cs, dts, ecs, w, in_decay, xs, Cs, Bs, hin, in_ds, carry, total;
  __host__ __device__ ClSmem(int P, int N, int Q, int C, bool with_carry,
                             int PB, int NB) {
    const size_t BS = N + 8, XS = P + 8, TS = NB + 8;
    size_t o = 0;
    cs = o;    o += 8 * (size_t)Q;                 // cumsum, fp64
    dts = o;   o += 4 * (size_t)Q;                 // dt
    ecs = o;   o += 4 * (size_t)Q;                 // exp(cs)
    w = o;     o += 4 * (size_t)Q;                 // dt exp(cs_end - cs)
    in_decay = o; o += 4 * kCluster;               // exp(cs_end) a chunk
    xs = o;    o += 2 * (size_t)Q * XS;            // x (Q x P)
    Cs = o;    o += 2 * (size_t)Q * BS;            // C (Q x N)
    Bs = o;                                        // B (Q x N)
    if (PB == P && NB == N) {
      // one tile: h_in's hi and lo (P x N each) over B, dead by then
      hin = o;
      o += 2 * ((size_t)Q > 2 * (size_t)P ? (size_t)Q : 2 * (size_t)P) * BS;
    } else {
      o += 2 * (size_t)Q * BS;                     // every tile reads B
      hin = o;   o += 2 * 2 * (size_t)PB * TS;     // h_in's pair, a tile
    }
    in_ds = o; o += 4 * (size_t)PB * TS;           // C slots x PB / C rows
    carry = o; o += with_carry ? 4 * (size_t)(P / C) * N : 0;
    total = o;
  }
};

// The state's tiles at (P, N, Q): rows in tiles of PB (the fewest tiles
// of at most cl_tile_pieces 16-row pieces, as even as they come; the
// last may be smaller), columns in tiles of NB (the fewest whose block,
// with a carry at a cluster of 8, fits an SM); {0, 0} where none fits.
struct ClTiles { int PB, NB; };
ClTiles cl_tiles(int P, int N, int Q) {
  const int pieces = P / 16, most = cl_tile_pieces(Q / 16);
  const int np = (pieces + most - 1) / most;
  const int PB = 16 * ((pieces + np - 1) / np);
  for (int nn = 1; nn <= N / 16; ++nn) {
    const int NB = 16 * ((N / 16 + nn - 1) / nn);
    if (ClSmem(P, N, Q, kCluster, true, PB, NB).total <= kMaxSmem)
      return {PB, NB};
  }
  return {0, 0};
}

size_t cl_smem(int P, int N, int Q, int C, bool carry) {
  const ClTiles t = cl_tiles(P, N, Q);
  return ClSmem(P, N, Q, C, carry, t.PB, t.NB).total;
}

// The tensor-core route takes (P, N, Q): bf16, multiples of 16, Q <=
// 128, and some tiling of the state whose block fits an SM.
bool tc_takes(int dtype, int P, int N, int Q) {
  return dtype == 1 && P > 0 && N > 0 && Q > 0 && P % 16 == 0 &&
         N % 16 == 0 && Q % 16 == 0 && Q <= kTcMaxQ &&
         cl_tiles(P, N, Q).PB > 0;
}

// `rows` rows of `width` bf16 (a multiple of 8), `stride` apart in global
// memory, into shared memory rows `ld` apart, by 16-byte cp.async: thread
// `tid` of `threads` takes pieces tid, tid + threads, ..., stepping the
// row and column without a division in the loop.
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int rows, int width, int stride,
                                          int ld, int tid, int threads) {
  const int per = width / 8;
  const int dj = threads / per, dc = threads % per;
  int j = tid / per, c = tid % per;
  for (; j < rows;) {
    mma::cp_async16(dst + j * ld + c * 8, src + (size_t)j * stride + c * 8,
                    16);
    j += dj;
    c += dc;
    if (c >= per) {
      c -= per;
      ++j;
    }
  }
}

// The block of (chunk c = round * C + rank, head h, batch row b).  Per
// round, with the cluster's ranks holding the round's chunks:
//   1. x, B, C by 16-byte cp.async; the fp64 cumsum, w and exp(cs);
// then per tile of the state (PB rows x NB columns; one tile at
// mamba2-130m's widths), row tiles outer:
//   2. the tile of dS_c = (x o w)^T B by mma.sync, x o w as a bf16 pair
//      formed from the x fragment, each fragment of the fp32 product
//      pushed to the rank that walks its rows (st.shared::cluster); on
//      the round's first tile also the chunk's decay exp(cs_end) to every
//      rank, then the scores C B^T and the masked M as bf16 pairs in
//      registers;
//   3. arrive (release); on a row tile's first columns y = M x at its
//      columns while the cluster arrives; wait (acquire): every increment
//      of the tile has landed;
//   4. each rank walks its PB / C rows of the tile over the round's chunks
//      in fp32, h = exp(cs_end,c) h + dS_c from its carry, pushing the
//      state that enters each chunk as a bf16 pair into its owner's h_in
//      (over B's dead copy where the state is one tile); the last round
//      writes the final state;
//   5. the whole barrier; y += exp(cs) o (C h_in^T) over the tile's
//      columns; y written once a row tile's columns are done.
// A rank past the last chunk of a round takes part in 3-5 only.
// kTiled: the state is more than one tile.  The one-tile instance runs
// each tile loop once by its constant bounds, so it keeps no loop state
// across the barriers: at Q = 64 it fits the 128 registers of two blocks
// a SM, where the tiled instance spills.
template <int QT, bool kTiled>
__global__ void __launch_bounds__(cl_threads<QT>(), QT <= 4 ? 2 : 1)
ssd_cluster_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_log,
                   const bf16* __restrict__ Bin, const bf16* __restrict__ Cin,
                   bf16* __restrict__ y, float* __restrict__ state_out,
                   int S, int H, int G, int P, int N, int PB, int NB,
                   int with_carry) {
  constexpr int Q = 16 * QT, NT = 2 * QT, kPairs = cl_pairs(QT);
  constexpr int kThr = cl_threads<QT>(), kHalves = scan_halves<QT>();
  static_assert(kThr >= Q, "a thread per step of the chunk");
  // every block of the cluster has started before the first push: arrive
  // now, wait once the first chunk is loaded
  hopper::cluster_arrive_relaxed();
  const int C = gridDim.x;
  const int rank = (int)hopper::cluster_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, rounds = (nc + C - 1) / C;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int BS = N + 8, XS = P + 8, TS = kTiled ? NB + 8 : BS;
  const int n_rt = kTiled ? (P + PB - 1) / PB : 1;   // row tiles
  const int n_ct = kTiled ? (N + NB - 1) / NB : 1;   // column tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClSmem lay(P, N, Q, C, with_carry != 0, PB, NB);
  double* cs = reinterpret_cast<double*>(smem_raw + lay.cs);
  float* dts = reinterpret_cast<float*>(smem_raw + lay.dts);
  float* ecs = reinterpret_cast<float*>(smem_raw + lay.ecs);
  float* w = reinterpret_cast<float*>(smem_raw + lay.w);
  float* in_decay = reinterpret_cast<float*>(smem_raw + lay.in_decay);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.xs);
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + lay.Cs);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + lay.Bs);
  bf16* hh = reinterpret_cast<bf16*>(smem_raw + lay.hin);
  bf16* hl = hh + (kTiled ? PB : P) * TS;
  float* in_ds = reinterpret_cast<float*>(smem_raw + lay.in_ds);
  float* carry = reinterpret_cast<float*>(smem_raw + lay.carry);

  const int slab = warp % QT, half = warp / QT;
  const int i0 = slab * 16;
  const int ra = i0 + gq, rb = ra + 8;   // this lane's rows of the chunk

  for (int k = 0; k < rounds; ++k) {
    const int nv = min(C, nc - k * C);    // chunks of this round
    const bool owns = rank < nv;
    const int c = k * C + rank, s0 = c * Q;
    if (owns) {
      // dt first: the cumsum waits on it, the products on the rest
      const size_t row0 = (size_t)b * S + s0;
      const float dtj = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
      copy_rows(Cs, Cin + (row0 * G + g) * N, Q, N, G * N, BS, tid, kThr);
      copy_rows(Bs, Bin + (row0 * G + g) * N, Q, N, G * N, BS, tid, kThr);
      copy_rows(xs, x + (row0 * H + h) * P, Q, P, H * P, XS, tid, kThr);
      mma::cp_async_commit();
      if (tid < Q) dts[tid] = dtj;
      __syncthreads();
      chunk_cumsum(cs, dts, -expf(a_log[h]), Q, tid);
      __syncthreads();
      const double cs_last = cs[Q - 1];
      for (int j = tid; j < Q; j += kThr) {
        w[j] = expf((float)(cs_last - cs[j])) * dts[j];
        ecs[j] = expf((float)cs[j]);
      }
      mma::cp_async_wait<0>();
      __syncthreads();
    }
    if (k == 0) hopper::cluster_wait();   // every block has started

    uint32_t mh[QT][4], ml[QT][4];
    for (int rt = 0; rt < n_rt; ++rt) {
      const int pb0 = rt * PB;
      const int pbt = kTiled ? min(PB, P - pb0) : P;   // the tile's rows
      const int RP = pbt / C;             // of them, those a rank walks
      // this warp's 16-column pairs of y in the tile: [pair_lo, pair_hi)
      const int tp = pbt / 16, per = (tp + kHalves - 1) / kHalves;
      const int pair_lo = pb0 / 16 + min(half * per, tp);
      const int pair_hi = min(pair_lo + per, pb0 / 16 + tp);
      float yacc[2 * kPairs][4];
#pragma unroll
      for (int n = 0; n < 2 * kPairs; ++n)
        yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;

      for (int ct = 0; ct < n_ct; ++ct) {
        const int nb0 = ct * NB;
        const int nbt = kTiled ? min(NB, N - nb0) : N;   // its columns
        const int n_end = nb0 + nbt;
        const bool first = rt == 0 && ct == 0;
        if (owns) {
          if (first && tid == 0) {          // the chunk's decay, to all
            const float decay = expf((float)cs[Q - 1]);
            for (int dst = 0; dst < C; ++dst)
              hopper::peer_store(hopper::peer_addr(in_decay + rank, dst),
                                 decay);
          }
          // the tile of dS = (x o w)^T B in units of 16 rows x 64 columns
          // a warp; its row p goes to rank p / RP, slot `rank`, row p % RP
          const int NU = (nbt + 63) / 64;
          for (int u = warp; u < tp * NU; u += kThr / 32) {
            const int p0 = pb0 + (u / NU) * 16, nb = nb0 + (u % NU) * 64;
            float acc[8][4];
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < QT; ++kk) {
              // x^T's fragment (rows p, steps j), times w_j, as hi + lo
              uint32_t ax[4], ah[4], al[4];
              mma::ldsm_x4_t(ax, xs + (kk * 16 + lane % 8 + (lane / 16) * 8) *
                                     XS + p0 + ((lane / 8) % 2) * 8);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int j = kk * 16 + 2 * t + (r >= 2 ? 8 : 0);
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&ax[r]));
                split2(f.x * w[j], f.y * w[j + 1], ah[r], al[r]);
              }
#pragma unroll
              for (int np = 0; np < 4; ++np) {
                const int n0 = nb + np * 16;
                if (n0 >= n_end) break;
                uint32_t bb[4];
                mma::ldsm_x4_t(bb, Bs + (kk * 16 + lane % 8 +
                                         ((lane / 8) % 2) * 8) * BS +
                                        n0 + (lane / 16) * 8);
                mma::mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
                mma::mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
                mma::mma_bf16(acc[2 * np], al, bb[0], bb[1]);
                mma::mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
              }
            }
            // 16 bytes a push: lanes t and t ^ 1 swap halves, so the even
            // lane holds row p0 + g at columns n..n+3 and the odd one row
            // p0 + g + 8 at n-2..n+1
            const bool odd = t & 1;
            const int pr = (odd ? p0 + gq + 8 : p0 + gq) - pb0;
            float* dr = in_ds + (rank * RP + pr % RP) * TS - nb0;
            const int owner = pr / RP;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int n = nb + nt * 8 + 2 * t;
              if (nb + nt * 8 >= n_end) break;
              const float s0v = odd ? acc[nt][0] : acc[nt][2];
              const float s1v = odd ? acc[nt][1] : acc[nt][3];
              const float r0 = __shfl_xor_sync(0xffffffffu, s0v, 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, s1v, 1);
              const float4 v = odd ? make_float4(r0, r1, acc[nt][2], acc[nt][3])
                                   : make_float4(acc[nt][0], acc[nt][1], r0, r1);
              hopper::peer_store4(
                  hopper::peer_addr(dr + n - (odd ? 2 : 0), owner), v);
            }
          }

          if (first) {
            // scores C B^T: 16 rows x Q keys, only key tiles at or left
            // of the diagonal (np <= slab)
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
            for (int kk = 0; kk < N / 16; ++kk) {
              uint32_t a[4];
              mma::ldsm_x4(a, Cs + (i0 + lane % 16) * BS + kk * 16 +
                                  (lane / 16) * 8);
#pragma unroll
              for (int np = 0; np < QT; ++np) {
                if (np > slab) break;
                uint32_t bb[4];
                mma::ldsm_x4(bb, Bs + (np * 16 + lane % 8 + (lane / 16) * 8) *
                                     BS + kk * 16 + ((lane / 8) % 2) * 8);
                mma::mma_bf16(s[2 * np], a, bb[0], bb[1]);
                mma::mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
              }
            }

            // M = scores o L o dt on the lower triangle, as bf16 hi + lo
            // fragments; branch-free (a masked decay is exp(-inf) = 0), so
            // the elements' exp chains overlap
            const double csa = cs[ra], csb = cs[rb];
            const float kNegInf = __int_as_float(0xff800000);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e < 2 ? ra : rb;
                const int j = nt * 8 + 2 * t + (e & 1);
                const float d = (float)((e < 2 ? csa : csb) - cs[j]);
                v[e] = s[nt][e] * expf(j <= i ? d : kNegInf) * dts[j];
              }
              split2(v[0], v[1], mh[nt / 2][(nt % 2) * 2],
                     ml[nt / 2][(nt % 2) * 2]);
              split2(v[2], v[3], mh[nt / 2][(nt % 2) * 2 + 1],
                     ml[nt / 2][(nt % 2) * 2 + 1]);
            }
          }
        }
        hopper::cluster_arrive();           // the pushes are out

        // y = M x at the row tile's columns while the cluster arrives
        if (owns && ct == 0) {
#pragma unroll
          for (int kk = 0; kk < QT; ++kk) {
            if (kk > slab) break;
#pragma unroll
            for (int np = 0; np < kPairs; ++np) {
              if (pair_lo + np >= pair_hi) break;
              const int p0 = (pair_lo + np) * 16;
              uint32_t bx[4];
              mma::ldsm_x4_t(bx, xs + (kk * 16 + lane % 8 +
                                       ((lane / 8) % 2) * 8) * XS +
                                      p0 + (lane / 16) * 8);
              mma::mma_bf16(yacc[2 * np], mh[kk], bx[0], bx[1]);
              mma::mma_bf16(yacc[2 * np + 1], mh[kk], bx[2], bx[3]);
              mma::mma_bf16(yacc[2 * np], ml[kk], bx[0], bx[1]);
              mma::mma_bf16(yacc[2 * np + 1], ml[kk], bx[2], bx[3]);
            }
          }
        }
        hopper::cluster_wait();             // the tile's dS and decays are here

        // this rank's rows of the tile over the round's chunks, 4 columns
        // a thread: the state entering chunk k C + j goes to rank j as a
        // bf16 pair (chunk 0 enters with zeros: nothing to push), 16 bytes
        // a push: lanes 2m and 2m + 1 hold columns n..n+3 and n+4..n+7 of
        // one row and swap halves, so the even lane pushes the 8 columns'
        // hi, the odd one their lo.  Every lane runs every step, so the
        // swaps are whole-warp.
        const int groups = RP * (nbt / 4);
        for (int e0 = 0; e0 < groups; e0 += kThr) {
          const int i = e0 + tid;
          const bool active = i < groups;
          const int r = active ? i / (nbt / 4) : 0;
          const int n = active ? 4 * (i % (nbt / 4)) : 0;
          const int pl = rank * RP + r;     // the row in the tile
          float* kept = carry + (pb0 / C + r) * N + nb0 + n;
          const bool odd = tid & 1;
          int j = 0;
          float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
          if (active) hv = ld4(k == 0 ? in_ds + r * TS + n : kept);
          if (k == 0) j = 1;
          for (; j < nv; ++j) {
            uint2 hi, lo;
            split2(hv.x, hv.y, hi.x, lo.x);
            split2(hv.z, hv.w, hi.y, lo.y);
            const uint2 send = odd ? hi : lo;
            uint2 got;
            got.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
            got.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
            if (active) {
              if (odd)
                hopper::peer_store_b128(
                    hopper::peer_addr(hl + pl * TS + n - 4, j),
                    make_uint4(got.x, got.y, lo.x, lo.y));
              else
                hopper::peer_store_b128(hopper::peer_addr(hh + pl * TS + n, j),
                                        make_uint4(hi.x, hi.y, got.x, got.y));
              const float4 d = ld4(in_ds + (j * RP + r) * TS + n);
              const float decay = in_decay[j];
              hv = make_float4(fmaf(decay, hv.x, d.x), fmaf(decay, hv.y, d.y),
                               fmaf(decay, hv.z, d.z), fmaf(decay, hv.w, d.w));
            }
          }
          if (!active) continue;
          if (k + 1 < rounds)
            st4(kept, hv);
          else
            st4(state_out + ((size_t)(b * H + h) * P + pb0 + pl) * N + nb0 + n,
                hv);
        }
        hopper::cluster_sync();             // every h_in push has landed

        if (owns && c > 0) {                // y += exp(cs) o (C h_in^T)
          float acc[2 * kPairs][4];
#pragma unroll
          for (int n = 0; n < 2 * kPairs; ++n)
            acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 4
          for (int kk = 0; kk < nbt / 16; ++kk) {
            uint32_t a[4];
            mma::ldsm_x4(a, Cs + (i0 + lane % 16) * BS + nb0 + kk * 16 +
                                (lane / 16) * 8);
#pragma unroll
            for (int np = 0; np < kPairs; ++np) {
              if (pair_lo + np >= pair_hi) break;
              const int p0 = (pair_lo + np) * 16 - pb0;
              const int off = (p0 + lane % 8 + (lane / 16) * 8) * TS +
                              kk * 16 + ((lane / 8) % 2) * 8;
              uint32_t bh[4], bl[4];
              mma::ldsm_x4(bh, hh + off);
              mma::ldsm_x4(bl, hl + off);
              mma::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
              mma::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
              mma::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
              mma::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
            }
          }
          const float ea = ecs[ra], eb = ecs[rb];
#pragma unroll
          for (int n = 0; n < 2 * kPairs; ++n) {
            yacc[n][0] = fmaf(ea, acc[n][0], yacc[n][0]);
            yacc[n][1] = fmaf(ea, acc[n][1], yacc[n][1]);
            yacc[n][2] = fmaf(eb, acc[n][2], yacc[n][2]);
            yacc[n][3] = fmaf(eb, acc[n][3], yacc[n][3]);
          }
        }
      }

      if (owns) {
        bf16* ya = y + ((size_t)(b * S + s0 + ra) * H + h) * P + 2 * t;
        bf16* yb = y + ((size_t)(b * S + s0 + rb) * H + h) * P + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 2 * kPairs; ++nt) {
          if (pair_lo + nt / 2 >= pair_hi) break;
          const int p = pair_lo * 16 + nt * 8;
          *reinterpret_cast<uint32_t*>(ya + p) =
              mma::pack_bf16(yacc[nt][0], yacc[nt][1]);
          *reinterpret_cast<uint32_t*>(yb + p) =
              mma::pack_bf16(yacc[nt][2], yacc[nt][3]);
        }
      }
    }
    if (k + 1 < rounds) __syncthreads();  // the next chunk lands over this one
  }
}

// f(std::integral_constant<int, QT>) for chunk Q = 16 QT, Q <= 128.
template <typename F>
int by_qt(int Q, F&& f) {
  switch (Q / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return -1;
  }
}

template <int QT>
cudaError_t cluster_attribute(int most) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_cluster_kernel<QT, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(ssd_cluster_kernel<QT, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most);
}

// The cluster kernel's attribute, set once per device for each of its
// instances (both of each chunk size): the most dynamic shared memory a block may ask for (each
// launch still asks only for what its shape needs; the kernel has no
// static shared memory).
cudaError_t tc_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  const cudaError_t each[] = {
      cluster_attribute<1>(most), cluster_attribute<2>(most),
      cluster_attribute<3>(most), cluster_attribute<4>(most),
      cluster_attribute<5>(most), cluster_attribute<6>(most),
      cluster_attribute<7>(most), cluster_attribute<8>(most)};
  for (const cudaError_t one : each)
    if (e == cudaSuccess) e = one;
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

bool rounds_carry(int nc, int C) { return (nc + C - 1) / C > 1; }

// f(QT, kTiled) as integral constants for the cluster kernel at (P, N, Q).
template <typename F>
int by_cluster_instance(int P, int N, int Q, F&& f) {
  const ClTiles t = cl_tiles(P, N, Q);
  const bool tiled = t.PB != P || t.NB != N;
  return by_qt(Q, [&](auto qt) {
    if (tiled) return f(qt, std::true_type{});
    return f(qt, std::false_type{});
  });
}

// The launch of C blocks a (head, batch row) as one cluster each.
template <int QT>
cudaLaunchConfig_t cl_config(int B, int H, int P, int N, int C, bool carry,
                             cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, B);
  cfg.blockDim = dim3(cl_threads<QT>(), 1, 1);
  cfg.dynamicSmemBytes = cl_smem(P, N, 16 * QT, C, carry);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch_cluster(const void* x, const float* dt, const float* a_log,
                   const void* Bin, const void* Cin, void* y, float* state,
                   int B, int S, int H, int G, int P, int N, int Q, int C,
                   cudaStream_t stream) {
  cudaError_t e = tc_attributes();
  if (e != cudaSuccess) return (int)e;
  const bool carry = rounds_carry(S / Q, C);
  const ClTiles tiles = cl_tiles(P, N, Q);
  return by_cluster_instance(P, N, Q, [&](auto qt, auto tiled) {
    constexpr int QT = decltype(qt)::value;
    constexpr bool kTiled = decltype(tiled)::value;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cl_config<QT>(B, H, P, N, C, carry, stream, &attr);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, ssd_cluster_kernel<QT, kTiled>, static_cast<const bf16*>(x),
        dt, a_log,
        static_cast<const bf16*>(Bin), static_cast<const bf16*>(Cin),
        static_cast<bf16*>(y), state, S, H, G, P, N, tiles.PB, tiles.NB,
        carry ? 1 : 0);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

// Clusters of C cluster-kernel blocks the card holds at once at (P, N, Q)
// (cudaOccupancyMaxActiveClusters), asked once per device and shape; a
// negated cudaError_t on a failure.
int max_active_clusters(int P, int N, int Q, int C, bool carry) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = tc_attributes();
  if (e != cudaSuccess) return -(int)e;
  static std::mutex mu;
  static std::vector<std::array<int, 7>> held;   // key, then the answer
  const std::array<int, 6> key = {dev, P, N, Q, C, carry ? 1 : 0};
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& r : held)
      if (std::equal(key.begin(), key.end(), r.begin())) return r[6];
  }
  const int n = by_cluster_instance(P, N, Q, [&](auto qt, auto tiled) {
    constexpr int QT = decltype(qt)::value;
    constexpr bool kTiled = decltype(tiled)::value;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cl_config<QT>(1, 1, P, N, C, carry, nullptr, &attr);
    int count = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &count, ssd_cluster_kernel<QT, kTiled>, &cfg);
    return err == cudaSuccess ? count : -(int)err;
  });
  if (n >= 0) {
    std::lock_guard<std::mutex> lock(mu);
    held.push_back({dev, P, N, Q, C, carry ? 1 : 0, n});
  }
  return n;
}

// The cluster size: of 1, 2, 4 and 8 (at most the chunks rounded up to a
// power of two), the one whose block, with the carry its rounds need,
// fits an SM and whose waves times rounds is least, the smaller on a tie.
// Waves: the (batch row, head) clusters over those the card holds at once
// (cudaOccupancyMaxActiveClusters, asked once per device and shape); a
// wave repeats the whole walk, a round only one chunk's.  A negated
// cudaError_t on a failure, or where no size fits.
int tc_cluster(int B, int S, int H, int P, int N, int Q) {
  const int nc = S / Q;
  const long long pairs = (long long)B * H;
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= kCluster && (c == 1 || c / 2 < nc); c *= 2) {
    const bool carry = rounds_carry(nc, c);
    if (cl_smem(P, N, Q, c, carry) > kMaxSmem) continue;
    const int held = max_active_clusters(P, N, Q, c, carry);
    if (held < 0) return held;
    if (held == 0) continue;
    const long long cost =
        ((pairs + held - 1) / held) * (long long)((nc + c - 1) / c);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best_cost < 0 ? -(int)cudaErrorInvalidConfiguration : best;
}

// ---------------------------------------------------------------------
// CUDA-core route (fp32; bf16 shapes the tensor cores refuse): three
// passes with fp32 workspaces
// ---------------------------------------------------------------------
__host__ __device__ inline int round16(int q) { return (q + 15) / 16 * 16; }

// Four elements of T (16 or 8 bytes) into four fp32 in shared memory: a
// cp.async for fp32, a load and a conversion for bf16.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  mma::cp_async16(dst, src, 16);
}
__device__ __forceinline__ void copy4(float* dst, const bf16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  st4(dst, make_float4(lo.x, lo.y, hi.x, hi.y));
}

size_t cc_state_smem(int P, int N, int Q) {
  // cs (fp64), dt, w; x (Q x P) and B (Q x N) in fp32
  return 16 * (size_t)Q + sizeof(float) * (size_t)Q * (P + N);
}

size_t cc_scan_smem(int P, int N, int Q) {
  // cs (fp64), dt and exp(cs) for Q16 rows; in fp32 C (Q16 x N+4), B and
  // then h_in (max(Q16, P) x N+4), M^T (Q16 x Q16+4) and x (Q x P)
  const size_t q16 = round16(Q), cs = (size_t)N + 4;
  const size_t rows_b = q16 > (size_t)P ? q16 : (size_t)P;
  return 16 * q16 +
         sizeof(float) * (q16 * cs + rows_b * cs + q16 * (q16 + 4) +
                          (size_t)Q * P);
}

size_t cc_smem(int P, int N, int Q) {
  const size_t a = cc_state_smem(P, N, Q), b = cc_scan_smem(P, N, Q);
  return a > b ? a : b;
}

// Pass 1.  Block (chunk c, head h, batch row b): the cumsum, w_j =
// exp(cs_end - cs_j) dt_j, then dS_c (P x N) = (x o w)^T B in fp32, each
// thread a 4 x 4 tile (p, n), summed over the chunk's steps in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cc_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log, const T* __restrict__ Bin,
                    float* __restrict__ ws, float* __restrict__ cs_end, int S,
                    int H, int G, int P, int N, int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cs + Q);
  float* w = dts + Q;
  float* xs = w + Q;                // Q x P (16 Q bytes in: aligned)
  float* Bs = xs + Q * P;           // Q x N

  for (int i = tid; i < Q * (P / 4); i += kThreads) {
    const int j = i / (P / 4), p4 = i % (P / 4);
    copy4(xs + j * P + 4 * p4,
          x + ((size_t)(b * S + s0 + j) * H + h) * P + 4 * p4);
  }
  for (int i = tid; i < Q * (N / 4); i += kThreads) {
    const int j = i / (N / 4), n4 = i % (N / 4);
    copy4(Bs + j * N + 4 * n4,
          Bin + ((size_t)(b * S + s0 + j) * G + g) * N + 4 * n4);
  }
  mma::cp_async_commit();
  for (int j = tid; j < Q; j += kThreads)
    dts[j] = dt[(size_t)(b * S + s0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(cs, dts, -expf(a_log[h]), Q, tid);
  __syncthreads();
  const double cs_last = cs[Q - 1];
  for (int j = tid; j < Q; j += kThreads)
    w[j] = expf((float)(cs_last - cs[j])) * dts[j];
  if (tid == 0) cs_end[((size_t)b * H + h) * nc + c] = (float)cs_last;
  mma::cp_async_wait<0>();
  __syncthreads();

  float* dsp = ws + ((size_t)(b * H + h) * nc + c) * P * N;
  const int NT = N / 4;
  for (int t = tid; t < (P / 4) * NT; t += kThreads) {
    const int tp = t / NT, tn = t % NT;
    float acc[4][4] = {};
    for (int j = 0; j < Q; ++j) {
      const float wj = w[j];
      float xv[4], bv[4];
      unpack(ld4(xs + j * P + 4 * tp), xv);
      unpack(ld4(Bs + j * N + 4 * tn), bv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xw = xv[k] * wj;
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[k][n] = fmaf(xw, bv[n], acc[k][n]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st4(dsp + (size_t)(4 * tp + k) * N + 4 * tn,
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]));
  }
}

// Pass 3.  Block (chunk c, head h, batch row b).  Two blocks a SM at
// mamba2-130m's widths (~100 KB of shared memory each, at most 128
// registers a thread).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_cc_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_log, const T* __restrict__ Bin,
                   const T* __restrict__ Cin, const float* __restrict__ h_in,
                   T* __restrict__ y, int S, int H, int G, int P, int N,
                   int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int Q16 = round16(Q), CS = N + 4, MS = Q16 + 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);  // Q16
  float* dts = reinterpret_cast<float*>(cs + Q16);   // Q16
  float* ecs = dts + Q16;                            // Q16: exp(cs)
  float* Cs = ecs + Q16;                             // Q16 x CS
  float* Bs = Cs + Q16 * CS;           // max(Q16, P) x CS: B, then h_in
  float* Mt = Bs + max(Q16, P) * CS;   // Q16 x MS: Mt[j][i] = M[i][j]
  float* xs = Mt + Q16 * MS;           // Q x P

  for (int i = tid; i < Q * (N / 4); i += kThreads) {
    const int j = i / (N / 4), n4 = i % (N / 4);
    const size_t off = ((size_t)(b * S + s0 + j) * G + g) * N + 4 * n4;
    copy4(Cs + j * CS + 4 * n4, Cin + off);
    copy4(Bs + j * CS + 4 * n4, Bin + off);
  }
  for (int i = tid; i < (Q16 - Q) * CS; i += kThreads) {
    Cs[Q * CS + i] = 0.f;               // rows that pad the 16-row pieces
    Bs[Q * CS + i] = 0.f;
  }
  for (int i = tid; i < Q * (P / 4); i += kThreads) {
    const int j = i / (P / 4), p4 = i % (P / 4);
    copy4(xs + j * P + 4 * p4,
          x + ((size_t)(b * S + s0 + j) * H + h) * P + 4 * p4);
  }
  mma::cp_async_commit();
  for (int j = tid; j < Q; j += kThreads)
    dts[j] = dt[(size_t)(b * S + s0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(cs, dts, -expf(a_log[h]), Q, tid);
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) ecs[j] = expf((float)cs[j]);
  mma::cp_async_wait<0>();
  __syncthreads();

  // scores C B^T on the FP64 tensor cores: warp w takes the 16 x 16
  // pieces (si, sj), sj <= si, numbered row by row, w, w + 8, ...; a
  // piece on the diagonal skips its upper-right 8 x 8 tile
  const int QT = Q16 / 16;
  for (int u = warp; u < QT * (QT + 1) / 2; u += kThreads / 32) {
    int si = 0;
    while ((si + 1) * (si + 2) / 2 <= u) ++si;
    const int sj = u - si * (si + 1) / 2;
    const int i0 = 16 * si, j0 = 16 * sj;
    const bool diag = si == sj;
    double acc[2][2][2] = {};
    const float* ca = Cs + (i0 + gq) * CS + t4;   // A: C (i, n)
    const float* ba = Bs + (j0 + gq) * CS + t4;   // B: B^T (n, j)
    for (int n0 = 0; n0 < N; n0 += 4) {
      const double a0 = ca[n0], a1 = ca[8 * CS + n0];
      const double b0 = ba[n0], b1 = ba[8 * CS + n0];
      mma::mma_f64(acc[0][0], a0, b0);
      if (!diag) mma::mma_f64(acc[0][1], a0, b1);
      mma::mma_f64(acc[1][0], a1, b0);
      mma::mma_f64(acc[1][1], a1, b1);
    }
    // M[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i < Q, else
    // 0, rounded once to fp32
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i0 + 8 * ii + gq, j = j0 + 8 * jj + 2 * t4 + e;
          float m = 0.f;
          if (j <= i && i < Q)
            m = (float)(acc[ii][jj][e] *
                        ((double)expf((float)(cs[i] - cs[j])) *
                         (double)dts[j]));
          Mt[j * MS + i] = m;
        }
  }
  __syncthreads();                      // M is whole; B's copy is dead

  if (c > 0) {                          // h_in lands over B while M x runs
    const float* hp = h_in + ((size_t)(b * H + h) * nc + c) * P * N;
    for (int i = tid; i < P * (N / 4); i += kThreads) {
      const int p = i / (N / 4), n4 = i % (N / 4);
      mma::cp_async16(Bs + p * CS + 4 * n4, hp + (size_t)p * N + 4 * n4, 16);
    }
    mma::cp_async_commit();
  }

  // y = M x + exp(cs) o (C h_in^T): thread tile rows 4 ti .. 4 ti + 3,
  // columns tp + PT k; every thread runs the same rounds, so the barrier
  // for h_in is reached by all
  const int PT = P / 4, n_tiles = (Q / 4) * PT;
  const float* hs = Bs;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    const bool active = t < n_tiles;
    const int ti = active ? t / PT : 0, tp = active ? t % PT : 0;
    float yi[4][4] = {};
    if (active) {
      for (int j = 0; j < 4 * ti + 4; ++j) {
        float m[4], xv[4];
        unpack(ld4(Mt + j * MS + 4 * ti), m);
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = xs[j * P + tp + PT * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) yi[r][k] = fmaf(m[r], xv[k], yi[r][k]);
      }
    }
    if (t0 == 0 && c > 0) {
      mma::cp_async_wait<0>();
      __syncthreads();                  // h_in has landed
    }
    // C h_in^T in two chains, even and odd n
    float ya[4][4] = {}, yb[4][4] = {};
    if (active && c > 0) {
      for (int n0 = 0; n0 < N; n0 += 4) {
        float cv[4][4], hv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) unpack(ld4(Cs + (4 * ti + r) * CS + n0), cv[r]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          unpack(ld4(hs + (tp + PT * k) * CS + n0), hv[k]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ya[r][k] = fmaf(cv[r][0], hv[k][0], ya[r][k]);
            yb[r][k] = fmaf(cv[r][1], hv[k][1], yb[r][k]);
            ya[r][k] = fmaf(cv[r][2], hv[k][2], ya[r][k]);
            yb[r][k] = fmaf(cv[r][3], hv[k][3], yb[r][k]);
          }
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        const float e = ecs[i];
        T* yrow = y + ((size_t)(b * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          yrow[tp + PT * k] =
              from_f32<T>(fmaf(e, ya[r][k] + yb[r][k], yi[r][k]));
      }
    }
  }
}

// Pass 2.  One thread per (b, h, p, n..n+3) walks the chunks, loads 16
// bytes wide, and writes the state entering chunk c >= 1 to h_in (B, H,
// nc, P, N) fp32 and the final state.  Chunk 0 enters with zeros and has
// no slot filled.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ ws,
                      const float* __restrict__ cs_end,
                      float* __restrict__ h_in, float* __restrict__ state_out,
                      long long BH, int nc, int PN) {
  const long long e0 =
      4 * ((long long)blockIdx.x * kPassThreads + threadIdx.x);
  if (e0 >= BH * PN) return;
  const long long bh = e0 / PN;
  const int pn = (int)(e0 % PN);
  const float4* p = reinterpret_cast<const float4*>(ws + (size_t)bh * nc * PN +
                                                    pn);
  float4* hp = reinterpret_cast<float4*>(h_in + (size_t)bh * nc * PN + pn);
  const float* ce = cs_end + bh * nc;
  const int cstride = PN / 4;            // float4 per chunk
  float4 hv = p[0];
#pragma unroll 4
  for (int c = 1; c < nc; ++c) {
    hp[(size_t)c * cstride] = hv;
    const float4 d = p[(size_t)c * cstride];
    const float decay = expf(ce[c]);
    hv = make_float4(decay * hv.x + d.x, decay * hv.y + d.y,
                     decay * hv.z + d.z, decay * hv.w + d.w);
  }
  *reinterpret_cast<float4*>(state_out + e0) = hv;
}

int launch_state_pass(const float* ws, const float* cs_end, float* h_in,
                      float* state, int B, int H, int nc, int PN,
                      cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const long long total = BH * PN / 4;   // threads, 4 elements each
  ssd_state_pass_kernel<<<(unsigned)((total + kPassThreads - 1) /
                                     kPassThreads),
                          kPassThreads, 0, stream>>>(ws, cs_end, h_in, state,
                                                     BH, nc, PN);
  return (int)cudaGetLastError();
}

// The CUDA-core block kernels' attributes, set once per device for each
// dtype: the most dynamic shared memory a block may ask for (each launch
// still asks only for what its shape needs; neither kernel has static
// shared memory), and for the chunk scan the largest carveout, so two of
// its blocks fit one SM.
template <typename T>
cudaError_t cc_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_cc_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_cc_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_cc_scan_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T>
int launch_cc(const void* x, const float* dt, const float* a_log,
              const void* Bin, const void* Cin, void* y, float* state,
              float* ws, float* h_in, float* cs_end, int B, int S, int H,
              int G, int P, int N, int Q, cudaStream_t stream) {
  const int nc = S / Q;
  auto state_kernel = ssd_cc_state_kernel<T>;
  auto scan_kernel = ssd_cc_scan_kernel<T>;
  const size_t smem1 = cc_state_smem(P, N, Q), smem3 = cc_scan_smem(P, N, Q);
  const cudaError_t e = cc_attributes<T>();
  if (e != cudaSuccess) return (int)e;
  state_kernel<<<dim3(nc, H, B), kThreads, smem1, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(Bin), ws,
      cs_end, S, H, G, P, N, Q);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_state_pass(ws, cs_end, h_in, state, B, H, nc, P * N, stream);
  if (err != 0) return err;
  scan_kernel<<<dim3(nc, H, B), kThreads, smem3, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(Bin),
      static_cast<const T*>(Cin), h_in, static_cast<T*>(y), S, H, G, P, N,
      Q);
  return (int)cudaGetLastError();
}

template <typename T>
int cc_scan_blocks_per_sm(int P, int N, int Q) {
  const size_t smem = cc_scan_smem(P, N, Q);
  auto kernel = ssd_cc_scan_kernel<T>;
  int n = 0;
  if (cc_attributes<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Bytes of shared memory the largest block of the CUDA-core route needs
// at (P, N, chunk Q); the wrapper refuses shapes that do not fit the
// card's 227 KB.
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return (long long)cc_smem(P, N, Q);
}

// Blocks of the CUDA-core chunk-scan kernel (the largest) one SM holds
// at (P, N, chunk Q, dtype), as the CUDA occupancy calculator counts
// them; -1 on an error.
extern "C" int ssd_scan_blocks_per_sm(int P, int N, int Q, int dtype) {
  return dtype ? cc_scan_blocks_per_sm<bf16>(P, N, Q)
               : cc_scan_blocks_per_sm<float>(P, N, Q);
}

// Bytes of shared memory the cluster kernel's block needs at (P, N, chunk
// Q, cluster size), with or without the carry of several rounds, for the
// shape's tiles; -1 where the tensor cores refuse the shape or the size.
extern "C" long long ssd_scan_tc_smem_bytes(int P, int N, int Q, int cluster,
                                            int carry) {
  if (!tc_takes(1, P, N, Q) || cluster < 1 || cluster > kCluster ||
      (cluster & (cluster - 1)))
    return -1;
  return (long long)cl_smem(P, N, Q, cluster, carry != 0);
}

// Clusters of `cluster` (1, 2, 4 or 8) cluster-kernel blocks the card
// holds at once at (P, N, chunk Q) with or without the carry, or -1 / a
// negated cudaError_t.
extern "C" int ssd_scan_max_active_clusters(int P, int N, int Q, int cluster,
                                            int carry) {
  if (!tc_takes(1, P, N, Q) || cluster < 1 || cluster > kCluster ||
      (cluster & (cluster - 1)))
    return -1;
  return max_active_clusters(P, N, Q, cluster, carry != 0);
}

// The cluster size `ssd_scan_fwd` launches bf16 (B, S, H, P, N, chunk Q)
// with on the tensor cores; -1 where the route refuses the shape, a
// negated cudaError_t on a failure.
extern "C" int ssd_scan_tc_cluster(int B, int S, int H, int P, int N,
                                   int Q) {
  if (Q <= 0 || S % Q || !tc_takes(1, P, N, Q)) return -1;
  return tc_cluster(B, S, H, P, N, Q);
}

// The tensor-core cluster kernel at a given cluster size (1, 2, 4 or 8;
// 0: the rule's), bf16 only, for shapes it takes; the return codes of
// `ssd_scan_fwd`.
extern "C" int ssd_scan_tc_fwd(const void* x, const void* dt,
                               const void* a_log, const void* Bin,
                               const void* Cin, void* y, void* state, int B,
                               int S, int H, int G, int P, int N, int Q,
                               int cluster, void* stream) {
  if (Q <= 0 || S % Q || G <= 0 || H % G || !tc_takes(1, P, N, Q) ||
      cluster < 0 || cluster > kCluster || (cluster & (cluster - 1)))
    return -1;
  if (cluster == 0) cluster = tc_cluster(B, S, H, P, N, Q);
  if (cluster < 0) return -cluster;
  return launch_cluster(x, static_cast<const float*>(dt),
                        static_cast<const float*>(a_log), Bin, Cin, y,
                        static_cast<float*>(state), B, S, H, G, P, N, Q,
                        cluster, static_cast<cudaStream_t>(stream));
}

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for an
// unsupported shape or dtype (dtype: 0 fp32, 1 bf16 for x, B, C and y).
// P, N and Q must be multiples of 4, S a multiple of Q, H of G.  route: 0
// by shape, 1 CUDA cores, 2 tensor cores.  The tensor cores take bf16
// with P, N, Q multiples of 16, Q <= 128 and a tiling of the state whose
// block fits an SM (`tc_takes`), as one cluster launch
// (`ssd_cluster_kernel`, no workspace: ws, h_in and cs_end are not read
// and may be null) at `ssd_scan_tc_cluster`'s size.  The CUDA cores' three
// passes need the workspaces ws (B, H, S/Q, P, N), h_in (B, H, S/Q, P, N)
// and cs_end (B, H, S/Q), all fp32.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* Bin, const void* Cin, void* y,
                            void* state, void* ws, void* h_in, void* cs_end,
                            int B, int S, int H, int G, int P, int N, int Q,
                            int dtype, int route, void* stream) {
  if (P % 4 || N % 4 || Q % 4 || Q <= 0 || S % Q || G <= 0 || H % G)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  float* st = static_cast<float*>(state);
  if (route == 0) route = tc_takes(dtype, P, N, Q) ? 2 : 1;
  if (route == 2) {
    if (!tc_takes(dtype, P, N, Q)) return -1;
    const int c = tc_cluster(B, S, H, P, N, Q);
    if (c < 0) return -c;
    return launch_cluster(x, d, al, Bin, Cin, y, st, B, S, H, G, P, N, Q, c,
                          s);
  }
  if (route != 1 || ws == nullptr || h_in == nullptr || cs_end == nullptr)
    return -1;
  float* wsf = static_cast<float*>(ws);
  float* hf = static_cast<float*>(h_in);
  float* ce = static_cast<float*>(cs_end);
  if (dtype == 0)
    return launch_cc<float>(x, d, al, Bin, Cin, y, st, wsf, hf, ce, B, S, H,
                            G, P, N, Q, s);
  if (dtype == 1)
    return launch_cc<bf16>(x, d, al, Bin, Cin, y, st, wsf, hf, ce, B, S, H,
                           G, P, N, Q, s);
  return -1;
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
