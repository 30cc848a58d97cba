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
// card's bound is the bytes.  On both routes the
// sequential chunk axis of the TPU kernel becomes three passes, so no
// block walks the sequence and every chunk is a block (192 blocks at B =
// 1, 768 at B = 4), and B and C are read per group (g = h / (H / G))
// straight from the (B, S, G, N) input, so the G -> H repeat the TPU
// wrapper makes is never materialised.  The cumsum of dt * A is taken in
// fp64 in each pass that needs it (warp 0: each lane sums a run, one warp
// scan adds the runs' offsets): the decays exp(cs_i - cs_j) take the
// difference of two cumulative sums that reach a few hundred over a
// chunk, and in fp32 that difference alone loses ~1e-5 of relative
// precision.
//
// Two routes, chosen by dtype and shape before the launch (never after a
// failure): `ssd_scan_fwd`'s `route` argument is 0 (by shape), 1 (CUDA
// cores) or 2 (tensor cores), and it returns -1 where a forced route
// cannot take the shape.
//
// Tensor-core route (bf16; P, N, Q multiples of 16, Q <= 128): the
// sequential chunk axis becomes three passes, so no block walks the
// sequence and every chunk is a block (192 blocks at B = 1, 768 at B = 4):
//   1. `ssd_chunk_state_kernel`, one block per (b, h, chunk): the cumsum,
//      then dS_c = (x o w)^T B with w_j = dt_j exp(cs_end - cs_j) (P x N)
//      by mma.sync, written with cs_end to fp32 workspaces;
//   2. `ssd_state_pass_kernel`, one thread per (b, h, p, 4 n):
//      h_c = exp(cs_end,c) h_{c-1} + dS_c over the chunks in fp32,
//      writing the state entering each chunk (as the bf16 pair below)
//      and the final state;
//   3. `ssd_chunk_scan_kernel`, one block per (b, h, chunk), two warps
//      per 16 rows that split y's columns: y = (C B^T o L o dt) x +
//      exp(cs) o (C h_in^T), both products by mma.sync, the masked score
//      matrix built on the fp32 accumulator fragment and fed back from
//      registers as the A operand.
// x, B and C are bf16 already and enter the products exactly.  The three
// operands the kernels compute (x o w, the masked scores, h_in) are each
// carried as a pair of bf16 values, hi = bf16(v) and lo = bf16(v - hi),
// and the product runs once per half: with a single bf16 rounding (8-bit
// mantissa) y misses the 2e-2 tolerance at mamba2-130m's widths in a CPU
// model of these passes (tests/test_torch_tensor_core.py), fp16 (10 bits)
// would turn bf16 inputs above 65504 into inf, and the pair (16 bits)
// stays near the error of exact products (rounding y to bf16).  The
// cumsum and the decay differences stay in fp64, as on the CUDA-core
// route.  The workspace traffic (dS and h_in, 4 bytes per (b, h, chunk,
// p, n) each, written once and read once) is this design's cost; it does
// not enter the bound.  A single wgmma kernel without the workspaces, its
// blocks handing the state from chunk to chunk through L2, was measured
// against these passes: faster at B = 4, slower at B = 1, where the
// chain of hand-offs sets the time, so it did not replace them (PERF.md,
// section 6).  The kernels' shared-memory limits are set once per device.
//
// CUDA-core route (fp32, and bf16 shapes the tensor cores refuse, such
// as P = 8; P, N and Q multiples of 4): the same three passes on the CUDA
// cores, with fp32 workspaces, so every chunk is a block here too:
//   1. `ssd_cc_state_kernel`, one block per (b, h, chunk): the cumsum,
//      then dS_c = (x o w)^T B (P x N) in fp32, each thread a 4 x 4 tile
//      over the chunk's Q steps, written with cs_end to fp32 workspaces
//      (~49 KB of shared memory at mamba2-130m's widths);
//   2. the state pass above, writing the state entering each chunk as
//      fp32 (the final state too);
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

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

// ---------------------------------------------------------------------
// tensor-core route (bf16): three passes
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcMaxQ = 128;
constexpr int kStateThreads = 128;       // pass 1
constexpr int kPassThreads = 256;        // pass 2

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

size_t tc_state_smem(int P, int N, int Q) {
  // cs (fp64), dt, w; B (Q x N+8); x o w hi and lo (Q x P+8 each)
  return 16 * (size_t)Q + sizeof(bf16) * ((size_t)Q * (N + 8) +
                                          2 * (size_t)Q * (P + 8));
}

size_t tc_scan_smem(int P, int N, int Q) {
  // cs (fp64), dt, exp(cs); C and B (Q x N+8); x (Q x P+8); h_in hi and
  // lo (P x N+8 each)
  return 16 * (size_t)Q + sizeof(bf16) * (2 * (size_t)Q * (N + 8) +
                                          (size_t)Q * (P + 8) +
                                          2 * (size_t)P * (N + 8));
}

size_t tc_smem(int P, int N, int Q) {
  const size_t a = tc_state_smem(P, N, Q), b = tc_scan_smem(P, N, Q);
  return a > b ? a : b;
}

bool tc_takes(int dtype, int P, int N, int Q) {
  return dtype == 1 && P > 0 && N > 0 && Q > 0 && P % 16 == 0 &&
         N % 16 == 0 && Q % 16 == 0 && Q <= kTcMaxQ &&
         tc_smem(P, N, Q) <= 232448;
}

// Pass 1.  Block (chunk c, head h, batch row b), 4 warps.
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const bf16* __restrict__ Bin, float* __restrict__ ws,
                       float* __restrict__ cs_end, int S, int H, int G,
                       int P, int N, int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int BS = N + 8, XS = P + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cs + Q);
  float* w = dts + Q;
  bf16* Bs = reinterpret_cast<bf16*>(w + Q);   // 16 Q bytes in: aligned
  bf16* xh = Bs + Q * BS;
  bf16* xl = xh + Q * XS;

  for (int i = tid; i < Q * (N / 8); i += kStateThreads) {
    const int j = i / (N / 8), cc = i % (N / 8);
    mma::cp_async16(Bs + j * BS + cc * 8,
                    Bin + ((size_t)(b * S + s0 + j) * G + g) * N + cc * 8,
                    16);
  }
  mma::cp_async_commit();
  for (int j = tid; j < Q; j += kStateThreads)
    dts[j] = dt[(size_t)(b * S + s0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(cs, dts, -expf(a_log[h]), Q, tid);
  __syncthreads();
  const double cs_last = cs[Q - 1];
  for (int j = tid; j < Q; j += kStateThreads)
    w[j] = expf((float)(cs_last - cs[j])) * dts[j];
  if (tid == 0) cs_end[((size_t)b * H + h) * nc + c] = (float)cs_last;
  __syncthreads();

  // x o w as bf16 hi + lo, 8 values a thread
  for (int i = tid; i < Q * (P / 8); i += kStateThreads) {
    const int j = i / (P / 8), cc = i % (P / 8);
    const uint4 raw = *reinterpret_cast<const uint4*>(
        x + ((size_t)(b * S + s0 + j) * H + h) * P + cc * 8);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float wj = w[j];
    uint4 hi, lo;
    uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(xv[u]);
      split2(f.x * wj, f.y * wj, hp[u], lp[u]);
    }
    *reinterpret_cast<uint4*>(xh + j * XS + cc * 8) = hi;
    *reinterpret_cast<uint4*>(xl + j * XS + cc * 8) = lo;
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // dS (P x N) = (x o w)^T B, in units of 16 rows x 64 columns per warp
  float* dsp = ws + ((size_t)(b * H + h) * nc + c) * P * N;
  const int NU = (N + 63) / 64;
  for (int u = warp; u < (P / 16) * NU; u += kStateThreads / 32) {
    const int p0 = (u / NU) * 16, nb = (u % NU) * 64;
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kk = 0; kk < Q / 16; ++kk) {
      const int arow = kk * 16 + lane % 8 + (lane / 16) * 8;
      const int acol = p0 + ((lane / 8) % 2) * 8;
      uint32_t ah[4], al[4];
      mma::ldsm_x4_t(ah, xh + arow * XS + acol);
      mma::ldsm_x4_t(al, xl + arow * XS + acol);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n0 = nb + np * 16;
        if (n0 >= N) break;
        uint32_t bb[4];
        mma::ldsm_x4_t(bb, Bs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                    BS + n0 + (lane / 16) * 8);
        mma::mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
        mma::mma_bf16(acc[2 * np], al, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nb + nt * 8 + 2 * t;
      if (n >= N) break;
      *reinterpret_cast<float2*>(dsp + (size_t)(p0 + gq) * N + n) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(dsp + (size_t)(p0 + gq + 8) * N + n) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// Pass 2, both routes.  One thread per (b, h, p, n..n+3) walks the
// chunks, loads 16 bytes wide.  The state entering chunk c >= 1 goes to
// h_in: for the tensor cores (kPair) as two bf16 planes, hi and lo, the
// layout pass 3 copies straight into shared memory, for the CUDA cores as
// fp32 (B, H, nc, P, N).  Chunk 0 enters with zeros and has no slot
// filled.
template <bool kPair>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ ws,
                      const float* __restrict__ cs_end,
                      void* __restrict__ h_in, float* __restrict__ state_out,
                      long long BH, int nc, int PN) {
  const long long e0 =
      4 * ((long long)blockIdx.x * kPassThreads + threadIdx.x);
  if (e0 >= BH * PN) return;
  const long long bh = e0 / PN;
  const int pn = (int)(e0 % PN);
  const float4* p = reinterpret_cast<const float4*>(ws + (size_t)bh * nc * PN +
                                                    pn);
  const float* ce = cs_end + bh * nc;
  const int cstride = PN / 4;            // float4 (and uint2) per plane
  float4 hv = p[0];
#pragma unroll 4
  for (int c = 1; c < nc; ++c) {
    if constexpr (kPair) {
      uint2* hp = reinterpret_cast<uint2*>(static_cast<bf16*>(h_in) +
                                           (size_t)bh * nc * 2 * PN + pn);
      uint2 hi, lo;
      split2(hv.x, hv.y, hi.x, lo.x);
      split2(hv.z, hv.w, hi.y, lo.y);
      hp[(size_t)c * 2 * cstride] = hi;
      hp[(size_t)c * 2 * cstride + cstride] = lo;
    } else {
      float4* hp = reinterpret_cast<float4*>(static_cast<float*>(h_in) +
                                             (size_t)bh * nc * PN + pn);
      hp[(size_t)c * cstride] = hv;
    }
    const float4 d = p[(size_t)c * cstride];
    const float decay = expf(ce[c]);
    hv = make_float4(decay * hv.x + d.x, decay * hv.y + d.y,
                     decay * hv.z + d.z, decay * hv.w + d.w);
  }
  *reinterpret_cast<float4*>(state_out + e0) = hv;
}

// Pass 3.  Block (chunk c, head h, batch row b): per 16-row slab of the
// chunk (Q = 16 QT), two warps that split y's columns (one for Q > 64,
// to stay within the SM's registers); each computes its slab's scores.
template <int QT>
__host__ __device__ constexpr int scan_halves() { return QT <= 4 ? 2 : 1; }

template <int QT>
__global__ void __launch_bounds__(32 * QT * scan_halves<QT>())
ssd_chunk_scan_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const bf16* __restrict__ Bin,
                      const bf16* __restrict__ Cin,
                      const bf16* __restrict__ h_in, bf16* __restrict__ y,
                      int S, int H, int G, int P, int N) {
  constexpr int Q = 16 * QT, NT = 2 * QT;
  constexpr int kThr = 32 * QT * scan_halves<QT>();
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int BS = N + 8, XS = P + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cs + Q);
  float* ecs = dts + Q;
  bf16* Cs = reinterpret_cast<bf16*>(ecs + Q);  // 16 Q bytes in: aligned
  bf16* Bs = Cs + Q * BS;
  bf16* xs = Bs + Q * BS;
  bf16* hh = xs + Q * XS;
  bf16* hl = hh + P * BS;

  for (int i = tid; i < Q * (N / 8); i += kThr) {
    const int j = i / (N / 8), cc = i % (N / 8);
    const size_t off = ((size_t)(b * S + s0 + j) * G + g) * N + cc * 8;
    mma::cp_async16(Cs + j * BS + cc * 8, Cin + off, 16);
    mma::cp_async16(Bs + j * BS + cc * 8, Bin + off, 16);
  }
  for (int i = tid; i < Q * (P / 8); i += kThr) {
    const int j = i / (P / 8), cc = i % (P / 8);
    mma::cp_async16(xs + j * XS + cc * 8,
                    x + ((size_t)(b * S + s0 + j) * H + h) * P + cc * 8, 16);
  }
  if (c > 0) {                           // h_in's hi and lo planes
    const bf16* hp = h_in + ((size_t)(b * H + h) * nc + c) * 2 * P * N;
    for (int i = tid; i < P * (N / 8); i += kThr) {
      const int p = i / (N / 8), cc = i % (N / 8);
      mma::cp_async16(hh + p * BS + cc * 8, hp + (size_t)p * N + cc * 8, 16);
      mma::cp_async16(hl + p * BS + cc * 8,
                      hp + (size_t)(P + p) * N + cc * 8, 16);
    }
  }
  mma::cp_async_commit();
  for (int j = tid; j < Q; j += kThr)
    dts[j] = dt[(size_t)(b * S + s0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(cs, dts, -expf(a_log[h]), Q, tid);
  __syncthreads();
  for (int j = tid; j < Q; j += kThr) ecs[j] = expf((float)cs[j]);
  mma::cp_async_wait<0>();
  __syncthreads();

  const int slab = warp % QT, half = warp / QT;
  const int i0 = slab * 16;
  const int ra = i0 + gq, rb = ra + 8;   // this lane's rows of the chunk
  // this warp's 16-column pairs of y: [pair_lo, pair_hi)
  const int per = (P / 16 + scan_halves<QT>() - 1) / scan_halves<QT>();
  const int pair_lo = min(half * per, P / 16);
  const int pair_hi = min(pair_lo + per, P / 16);

  // scores C B^T: 16 rows x Q keys, only key tiles at or left of the
  // diagonal (np <= slab)
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    mma::ldsm_x4(a, Cs + (i0 + lane % 16) * BS + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < QT; ++np) {
      if (np > slab) break;
      uint32_t bb[4];
      mma::ldsm_x4(bb, Bs + (np * 16 + lane % 8 + (lane / 16) * 8) * BS +
                           kk * 16 + ((lane / 8) % 2) * 8);
      mma::mma_bf16(s[2 * np], a, bb[0], bb[1]);
      mma::mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
    }
  }

  // M = scores o L o dt on the lower triangle, as bf16 hi + lo fragments
  uint32_t mh[QT][4], ml[QT][4];
  const double csa = cs[ra], csb = cs[rb];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ra : rb;
      const int j = nt * 8 + 2 * t + (e & 1);
      v[e] = j <= i ? s[nt][e] * expf((float)((e < 2 ? csa : csb) - cs[j])) *
                          dts[j]
                    : 0.f;
    }
    split2(v[0], v[1], mh[nt / 2][(nt % 2) * 2], ml[nt / 2][(nt % 2) * 2]);
    split2(v[2], v[3], mh[nt / 2][(nt % 2) * 2 + 1],
           ml[nt / 2][(nt % 2) * 2 + 1]);
  }
  const float ea = ecs[ra], eb = ecs[rb];

  // y = exp(cs) o (C h_in^T) + M x, 4 column pairs at a time
  for (int pp0 = pair_lo; pp0 < pair_hi; pp0 += 4) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (c > 0) {
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4];
        mma::ldsm_x4(a, Cs + (i0 + lane % 16) * BS + kk * 16 +
                            (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (pp0 + np >= pair_hi) break;
          const int p0 = (pp0 + np) * 16;
          const int off = (p0 + lane % 8 + (lane / 16) * 8) * BS + kk * 16 +
                          ((lane / 8) % 2) * 8;
          uint32_t bh[4], bl[4];
          mma::ldsm_x4(bh, hh + off);
          mma::ldsm_x4(bl, hl + off);
          mma::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
          mma::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
          mma::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
          mma::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= ea;
        acc[n][1] *= ea;
        acc[n][2] *= eb;
        acc[n][3] *= eb;
      }
    }
#pragma unroll
    for (int kk = 0; kk < QT; ++kk) {
      if (kk > slab) break;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (pp0 + np >= pair_hi) break;
        const int p0 = (pp0 + np) * 16;
        uint32_t bx[4];
        mma::ldsm_x4_t(bx, xs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                    XS + p0 + (lane / 16) * 8);
        mma::mma_bf16(acc[2 * np], mh[kk], bx[0], bx[1]);
        mma::mma_bf16(acc[2 * np + 1], mh[kk], bx[2], bx[3]);
        mma::mma_bf16(acc[2 * np], ml[kk], bx[0], bx[1]);
        mma::mma_bf16(acc[2 * np + 1], ml[kk], bx[2], bx[3]);
      }
    }
    bf16* ya = y + ((size_t)(b * S + s0 + ra) * H + h) * P + 2 * t;
    bf16* yb = y + ((size_t)(b * S + s0 + rb) * H + h) * P + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (pp0 + nt / 2 >= pair_hi) break;
      const int p = pp0 * 16 + nt * 8;
      *reinterpret_cast<uint32_t*>(ya + p) =
          mma::pack_bf16(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(yb + p) =
          mma::pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
}

template <bool kPair>
int launch_state_pass(const float* ws, const float* cs_end, void* h_in,
                      float* state, int B, int H, int nc, int PN,
                      cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const long long total = BH * PN / 4;   // threads, 4 elements each
  ssd_state_pass_kernel<kPair><<<(unsigned)((total + kPassThreads - 1) /
                                            kPassThreads),
                                 kPassThreads, 0, stream>>>(ws, cs_end, h_in,
                                                            state, BH, nc, PN);
  return (int)cudaGetLastError();
}

template <int QT>
int launch_scan(const void* x, const float* dt, const float* a_log,
                const void* Bin, const void* Cin, const bf16* h_in, void* y,
                int B, int S, int H, int G, int P, int N, size_t smem,
                cudaStream_t stream) {
  ssd_chunk_scan_kernel<QT><<<dim3(S / (16 * QT), H, B), 32 * QT * scan_halves<QT>(), smem,
           stream>>>(
      static_cast<const bf16*>(x), dt, a_log, static_cast<const bf16*>(Bin),
      static_cast<const bf16*>(Cin), h_in, static_cast<bf16*>(y), S, H, G,
      P, N);
  return (int)cudaGetLastError();
}

template <int QT>
cudaError_t scan_smem_attribute(int most) {
  return cudaFuncSetAttribute(ssd_chunk_scan_kernel<QT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most);
}

// The tensor-core block kernels' attribute, set once per device: the
// most dynamic shared memory a block may ask for (each launch still asks
// only for what its shape needs; neither kernel has static shared
// memory), for the chunk-state kernel and every chunk-scan instance.
cudaError_t tc_attributes() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  const cudaError_t scan[] = {
      scan_smem_attribute<1>(most), scan_smem_attribute<2>(most),
      scan_smem_attribute<3>(most), scan_smem_attribute<4>(most),
      scan_smem_attribute<5>(most), scan_smem_attribute<6>(most),
      scan_smem_attribute<7>(most), scan_smem_attribute<8>(most)};
  for (const cudaError_t one : scan)
    if (e == cudaSuccess) e = one;
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

int launch_tc(const void* x, const float* dt, const float* a_log,
              const void* Bin, const void* Cin, void* y, float* state,
              float* ws, bf16* h_in, float* cs_end, int B, int S, int H,
              int G, int P, int N, int Q, cudaStream_t stream) {
  const int nc = S / Q;
  const size_t smem1 = tc_state_smem(P, N, Q);
  const cudaError_t e = tc_attributes();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_state_kernel<<<dim3(nc, H, B), kStateThreads, smem1, stream>>>(
      static_cast<const bf16*>(x), dt, a_log, static_cast<const bf16*>(Bin),
      ws, cs_end, S, H, G, P, N, Q);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  err = launch_state_pass<true>(ws, cs_end, h_in, state, B, H, nc, P * N,
                                stream);
  if (err != 0) return err;

  const size_t smem3 = tc_scan_smem(P, N, Q);
  switch (Q / 16) {
    case 1: return launch_scan<1>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 2: return launch_scan<2>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 3: return launch_scan<3>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 4: return launch_scan<4>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 5: return launch_scan<5>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 6: return launch_scan<6>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 7: return launch_scan<7>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    case 8: return launch_scan<8>(x, dt, a_log, Bin, Cin, h_in, y, B, S, H, G, P, N, smem3, stream);
    default: return -1;
  }
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
  err = launch_state_pass<false>(ws, cs_end, h_in, state, B, H, nc, P * N,
                                 stream);
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

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for an
// unsupported shape or dtype (dtype: 0 fp32, 1 bf16 for x, B, C and y).
// P, N and Q must be multiples of 4, S a multiple of Q, H of G.  route: 0
// by shape (tensor cores for bf16 with P, N, Q multiples of 16, Q <= 128
// and the blocks' shared memory within 227 KB, else CUDA cores), 1 CUDA
// cores, 2 tensor cores.  Both routes enqueue three kernels and need the
// workspaces ws (B, H, S/Q, P, N) fp32 and cs_end (B, H, S/Q) fp32, and
// h_in: (B, H, S/Q, 2, P, N) bf16 for the tensor cores, (B, H, S/Q, P, N)
// fp32 for the CUDA cores.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* Bin, const void* Cin, void* y,
                            void* state, void* ws, void* h_in, void* cs_end,
                            int B, int S, int H, int G, int P, int N, int Q,
                            int dtype, int route, void* stream) {
  if (P % 4 || N % 4 || Q % 4 || Q <= 0 || S % Q || G <= 0 || H % G ||
      ws == nullptr || h_in == nullptr || cs_end == nullptr)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  float* st = static_cast<float*>(state);
  float* wsf = static_cast<float*>(ws);
  float* ce = static_cast<float*>(cs_end);
  if (route == 0) route = tc_takes(dtype, P, N, Q) ? 2 : 1;
  if (route == 2) {
    if (!tc_takes(dtype, P, N, Q)) return -1;
    return launch_tc(x, d, al, Bin, Cin, y, st, wsf, static_cast<bf16*>(h_in),
                     ce, B, S, H, G, P, N, Q, s);
  }
  if (route != 1) return -1;
  float* hf = static_cast<float*>(h_in);
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
