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
// Design of the CUDA-core route.  The TPU kernel carries the state
// across a sequential grid axis over chunks.  Blocks on Hopper run in no
// order, so one block owns one (b, h) pair and walks its chunks in a
// loop, with the state in shared memory for the whole sequence.  On both
// routes B and C are read per group (g = h / (H / G)) straight from the
// (B, S, G, N) input, so the G -> H repeat the TPU wrapper makes is never
// materialised.  Each chunk: load
// x, B, C, dt into shared memory as fp32 (B and C transposed, n-major);
// warp 0 takes the cumsum (in fp64, see below); then three register-tiled
// passes, every thread owning a 4 x 4 output tile and reading its
// operands as 16-byte vectors: (A) the masked score matrix M[i][j] = (C_i . B_j)
// exp(cs_i - cs_j) dt_j for the lower triangle, stored transposed;
// (B+C) y = M x + exp(cs) (C h_prev^T), written to device memory;
// (D) the state update.  Row strides of Q + 4 floats keep the vectors
// aligned and the rows that one warp reads in different banks.
//
// Precision.  The decays exp(cs_i - cs_j) take the difference of two
// cumulative sums that reach a few hundred over a chunk; in fp32 that
// difference loses ~1e-5 of relative precision, which moves y past the
// fp32 tolerance (2e-5 + 2e-5 |y|) against the sequential recurrence at
// the serving shape below.  The cumsum and the differences are therefore
// taken in fp64 (Q values and Q^2/2 subtractions per chunk).  At that
// shape y is a sum of terms of up to a few hundred in magnitude, so a
// score matrix M = (C B^T) o decay o dt rounded to fp32 still moves y by
// up to ~1e-4 from the recurrence evaluated in fp64 (a CPU model of this
// kernel: 0.8-1.2 of the tolerance over three seeds; the fp32 recurrence
// itself lands at 1.03-1.16).  So M is formed and kept in fp64 and both
// sums of y (M x and C h_prev^T) accumulate in fp64, which brings the
// model to 0.08-0.12 of the tolerance; the state stays fp32.
//
// What bounds it on an H100.  At mamba2-130m's serving shapes (B = 4,
// S = 512, H = 24, P = 64, G = 1, N = 128, Q = 64) one call moves ~17 MB
// in bf16 (x, y, B, C, dt and the fp32 state: ~5 us at 3.35 TB/s) and
// does 2 (Q^2 N + Q^2 P + 2 Q N P) flops per (b, h, chunk), 2.8 GFLOP:
// ~42 us on the fp32 CUDA cores (67 TFLOP/s), ~3 us on the bf16 tensor
// cores, so in bf16 the card's bound is the bytes.
//
// Two routes, chosen by dtype and shape before the launch (never after a
// failure): `ssd_scan_fwd`'s `route` argument is 0 (by shape), 1 (CUDA
// cores) or 2 (tensor cores), and it returns -1 where a forced route
// cannot take the shape.
//
// CUDA-core route (fp32, and shapes the tensor cores do not take):
// `ssd_kernel` below, one 256-thread block per (b, h) that walks the
// chunks in fp32 (96 blocks at B = 4, 24 at B = 1; ~155 KB of shared
// memory allows one block per SM).  It is bound by the length of one
// block's chain of chunks and by issuing shared-memory loads and FMAs.
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
// not enter the bound.

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

size_t smem_bytes(int P, int N, int Q) {
  const size_t QS = (size_t)Q + 4;
  // fp64: M^T (Q x QS), cs (Q); fp32: state (N x P), B^T and C^T (N x QS
  // each), x (Q x P), w / dt (Q each)
  return sizeof(double) * ((size_t)Q * QS + Q) +
         sizeof(float) * ((size_t)N * P + 2 * (size_t)N * QS +
                          (size_t)Q * P + 2 * (size_t)Q);
}

// One block: head blockIdx.x of batch row blockIdx.y, all chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ Bin,
           const T* __restrict__ Cin, T* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int G, int P,
           int N, int Q) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int QS = Q + 4;
  const int QT = Q / 4, PT = P / 4, NT = N / 4;

  extern __shared__ float4 smem4[];            // 16-byte aligned
  double* Mt = reinterpret_cast<double*>(smem4);  // Q x QS: Mt[j][i] = M[i][j]
  double* cs = Mt + Q * QS;         // Q: inclusive cumsum of dt * A
  // the fp32 arrays start 16-byte aligned: Q (Q + 5) doubles, Q % 4 == 0
  float* ht = reinterpret_cast<float*>(cs + Q);  // N x P: the state
  float* Bt = ht + N * P;           // N x QS: B^T of the chunk
  float* Ct = Bt + N * QS;          // N x QS: C^T of the chunk
  float* xs = Ct + N * QS;          // Q x P
  float* wj = xs + Q * P;           // Q: exp(cs_end - cs_j) dt_j
  float* dts = wj + Q;              // Q: dt

  const float A = -expf(a_log[h]);
  for (int i = tid; i < N * P; i += kThreads) ht[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is consumed; the state is set
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i % P;
      xs[i] = to_f32(x[((size_t)(b * S + s0 + j) * H + h) * P + p]);
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const size_t off = ((size_t)(b * S + s0 + j) * G + g) * N + n;
      Bt[n * QS + j] = to_f32(Bin[off]);
      Ct[n * QS + j] = to_f32(Cin[off]);
    }
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = dt[(size_t)(b * S + s0 + j) * H + h];
    __syncthreads();

    if (tid < 32) {
      // each lane sums a run of ceil(Q/32) steps, then one warp scan
      // of the run totals gives every run its offset
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
    __syncthreads();

    const double cs_end = cs[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      wj[j] = expf((float)(cs_end - cs[j])) * dts[j];

    // (A) M[i][j] in fp64 for the lower-triangle 4 x 4 tiles, stored as
    // Mt[j][i]
    for (int t = tid; t < QT * QT; t += kThreads) {
      const int ti = t / QT, tj = t % QT;
      if (tj > ti) continue;
      double acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float c[4], bb[4];
        unpack(ld4(Ct + n * QS + 4 * ti), c);
        unpack(ld4(Bt + n * QS + 4 * tj), bb);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[r][k] = fma((double)c[r], (double)bb[k], acc[r][k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * tj + k;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti + r;
          Mt[j * QS + i] = j <= i ? acc[r][k] * exp(cs[i] - cs[j]) * dts[j]
                                  : 0.0;
        }
      }
    }
    __syncthreads();

    // (B + C) y = M x + exp(cs) * (C h_prev^T), per 4 x 4 tile of (i, p),
    // both sums in fp64
    for (int t = tid; t < QT * PT; t += kThreads) {
      const int ti = t / PT, tp = t % PT;
      double intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < 4 * ti + 4; ++j) {
        const double* m = Mt + j * QS + 4 * ti;
        float xv[4];
        unpack(ld4(xs + j * P + 4 * tp), xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            intra[r][k] = fma(m[r], (double)xv[k], intra[r][k]);
      }
      for (int n = 0; n < N; ++n) {
        float c[4], hv[4];
        unpack(ld4(Ct + n * QS + 4 * ti), c);
        unpack(ld4(ht + n * P + 4 * tp), hv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            inter[r][k] = fma((double)c[r], (double)hv[k], inter[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        const double e = exp(cs[i]);
        T* yrow = y + ((size_t)(b * S + s0 + i) * H + h) * P + 4 * tp;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          yrow[k] = from_f32<T>((float)(intra[r][k] + inter[r][k] * e));
      }
    }
    __syncthreads();  // every read of h_prev is done

    // (D) h = exp(cs_end) h_prev + sum_j w_j x_j (x) B_j, per (n, p) tile
    const float decay = expf((float)cs_end);
    for (int t = tid; t < NT * PT; t += kThreads) {
      const int tn = t / PT, tp = t % PT;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hv[4];
        unpack(ld4(ht + (4 * tn + r) * P + 4 * tp), hv);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = hv[k] * decay;
      }
      for (int j = 0; j < Q; ++j) {
        const float w = wj[j];
        float xv[4], bw[4];
        unpack(ld4(xs + j * P + 4 * tp), xv);
#pragma unroll
        for (int r = 0; r < 4; ++r) bw[r] = Bt[(4 * tn + r) * QS + j] * w;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(bw[r], xv[k], acc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st4(ht + (4 * tn + r) * P + 4 * tp,
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  }
  __syncthreads();

  float* so = state_out + (size_t)(b * H + h) * P * N;   // (P, N) row
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    so[i] = ht[n * P + p];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log,
           const void* Bin, const void* Cin, void* y, float* state,
           int B, int S, int H, int G, int P, int N, int Q,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  auto kernel = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(Bin),
      static_cast<const T*>(Cin), static_cast<T*>(y), state, S, H, G, P, N,
      Q);
  return (int)cudaGetLastError();
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

// Pass 2.  One thread per (b, h, p, n..n+3) walks the chunks, loads
// 16 bytes wide.  The state entering chunk c >= 1 goes to h_in as two
// bf16 planes, hi and lo, the layout pass 3 copies straight into shared
// memory (chunk 0 enters with zeros and has no slot filled).
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ ws,
                      const float* __restrict__ cs_end,
                      bf16* __restrict__ h_in, float* __restrict__ state_out,
                      long long BH, int nc, int PN) {
  const long long e0 =
      4 * ((long long)blockIdx.x * kPassThreads + threadIdx.x);
  if (e0 >= BH * PN) return;
  const long long bh = e0 / PN;
  const int pn = (int)(e0 % PN);
  const float4* p = reinterpret_cast<const float4*>(ws + (size_t)bh * nc * PN +
                                                    pn);
  const float* ce = cs_end + bh * nc;
  uint2* hp = reinterpret_cast<uint2*>(h_in + (size_t)bh * nc * 2 * PN + pn);
  const int cstride = PN / 4;            // float4 (and uint2) per plane
  float4 hv = p[0];
#pragma unroll 4
  for (int c = 1; c < nc; ++c) {
    uint2 hi, lo;
    split2(hv.x, hv.y, hi.x, lo.x);
    split2(hv.z, hv.w, hi.y, lo.y);
    hp[(size_t)c * 2 * cstride] = hi;
    hp[(size_t)c * 2 * cstride + cstride] = lo;
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

template <int QT>
int launch_scan(const void* x, const float* dt, const float* a_log,
                const void* Bin, const void* Cin, const bf16* h_in, void* y,
                int B, int S, int H, int G, int P, int N, size_t smem,
                cudaStream_t stream) {
  auto kernel = ssd_chunk_scan_kernel<QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(S / (16 * QT), H, B), 32 * QT * scan_halves<QT>(), smem,
           stream>>>(
      static_cast<const bf16*>(x), dt, a_log, static_cast<const bf16*>(Bin),
      static_cast<const bf16*>(Cin), h_in, static_cast<bf16*>(y), S, H, G,
      P, N);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, const float* dt, const float* a_log,
              const void* Bin, const void* Cin, void* y, float* state,
              float* ws, bf16* h_in, float* cs_end, int B, int S, int H,
              int G, int P, int N, int Q, cudaStream_t stream) {
  const int nc = S / Q;
  const size_t smem1 = tc_state_smem(P, N, Q);
  if (smem1 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_chunk_state_kernel<<<dim3(nc, H, B), kStateThreads, smem1, stream>>>(
      static_cast<const bf16*>(x), dt, a_log, static_cast<const bf16*>(Bin),
      ws, cs_end, S, H, G, P, N, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long BH = (long long)B * H;
  const long long total = BH * P * N / 4;   // threads, 4 elements each
  ssd_state_pass_kernel<<<(unsigned)((total + kPassThreads - 1) /
                                     kPassThreads),
                          kPassThreads, 0, stream>>>(ws, cs_end, h_in, state,
                                                     BH, nc, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

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

}  // namespace

// Bytes of shared memory one block of the CUDA-core route needs at
// (P, N, chunk Q); the wrapper refuses shapes that do not fit the card's
// 227 KB.
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return (long long)smem_bytes(P, N, Q);
}

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for an
// unsupported shape or dtype (dtype: 0 fp32, 1 bf16 for x, B, C and y).
// P, N and Q must be multiples of 4, S a multiple of Q, H of G.  route: 0
// by shape (tensor cores for bf16 with P, N, Q multiples of 16, Q <= 128
// and the blocks' shared memory within 227 KB, else CUDA cores), 1 CUDA
// cores, 2 tensor cores.  The tensor-core route needs the workspaces ws
// (B, H, S/Q, P, N) fp32, h_in (B, H, S/Q, 2, P, N) bf16 and cs_end
// (B, H, S/Q) fp32, and enqueues three kernels; the CUDA-core route
// ignores them and enqueues one.
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
    if (!tc_takes(dtype, P, N, Q) || ws == nullptr || h_in == nullptr ||
        cs_end == nullptr)
      return -1;
    return launch_tc(x, d, al, Bin, Cin, y, st, static_cast<float*>(ws),
                     static_cast<bf16*>(h_in), static_cast<float*>(cs_end), B,
                     S, H, G, P, N, Q, s);
  }
  if (route != 1) return -1;
  if (dtype == 0)
    return launch<float>(x, d, al, Bin, Cin, y, st, B, S, H, G, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, d, al, Bin, Cin, y, st, B, S, H, G, P,
                                 N, Q, s);
  return -1;
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
