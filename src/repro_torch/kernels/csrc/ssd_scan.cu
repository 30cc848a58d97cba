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
// Design.  The TPU kernel carries the state across a sequential grid
// axis over chunks.  Blocks on Hopper run in no order, so one block owns
// one (b, h) pair and walks its chunks in a loop, with the state in
// shared memory for the whole sequence.  B and C are read per group
// (g = h / (H / G)) straight from the (B, S, G, N) input, so the G -> H
// repeat the TPU wrapper makes is never materialised.  Each chunk: load
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
// the serving shape below.  The cumsum and the differences are therefore taken in fp64
// (Q values and Q^2/2 subtractions per chunk), and only their exp in
// fp32: the products of per-step decays the recurrence multiplies are
// then reproduced to fp32 rounding.
//
// What bounds it on an H100.  At mamba2-130m's serving shapes (B = 4,
// S = 512, H = 24, P = 64, G = 1, N = 128, Q = 64) one call moves ~17 MB
// in bf16 (x, y, B, C, dt and the fp32 state: ~5 us at 3.35 TB/s) and
// does 2 (Q^2 N + Q^2 P + 2 Q N P) flops per (b, h, chunk), 2.8 GFLOP:
// ~42 us on the fp32 CUDA cores (67 TFLOP/s), ~3 us on the bf16 tensor
// cores, so in bf16 the card's bound is the bytes.
// This first version computes on the CUDA cores in fp32 with one
// 256-thread block per (b, h) (96 blocks, under one wave of 132 SMs;
// ~137 KB of shared memory at these shapes allows one block per SM), so
// it is bound by issuing shared-memory loads and FMAs at low occupancy.
// The tensor-core version (wgmma on the three products) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
  // state (N x P), B^T and C^T (N x QS each), x (Q x P), M^T (Q x QS),
  // cs (Q doubles), w / exp(cs) / dt (Q each)
  return sizeof(float) * ((size_t)N * P + 2 * (size_t)N * QS +
                          (size_t)Q * P + (size_t)Q * QS + 5 * (size_t)Q);
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
  float* smem = reinterpret_cast<float*>(smem4);
  float* ht = smem;                 // N x P: the state, n-major
  float* Bt = ht + N * P;           // N x QS: B^T of the chunk
  float* Ct = Bt + N * QS;          // N x QS: C^T of the chunk
  float* xs = Ct + N * QS;          // Q x P
  float* Mt = xs + Q * P;           // Q x QS: Mt[j][i] = M[i][j]
  // Q: inclusive cumsum of dt * A, fp64 (the offset is 16-byte aligned)
  double* cs = reinterpret_cast<double*>(Mt + Q * QS);
  float* wj = reinterpret_cast<float*>(cs + Q);  // Q: exp(cs_end - cs_j) dt_j
  float* ecs = wj + Q;              // Q: exp(cs_i)
  float* dts = ecs + Q;             // Q: dt

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
    for (int j = tid; j < Q; j += kThreads) {
      wj[j] = expf((float)(cs_end - cs[j])) * dts[j];
      ecs[j] = expf((float)cs[j]);
    }

    // (A) M[i][j] for the lower-triangle 4 x 4 tiles, stored as Mt[j][i]
    for (int t = tid; t < QT * QT; t += kThreads) {
      const int ti = t / QT, tj = t % QT;
      if (tj > ti) continue;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float c[4], bb[4];
        unpack(ld4(Ct + n * QS + 4 * ti), c);
        unpack(ld4(Bt + n * QS + 4 * tj), bb);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(c[r], bb[k], acc[r][k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * tj + k;
        float m[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti + r;
          m[r] = j <= i ? acc[r][k] * expf((float)(cs[i] - cs[j])) * dts[j]
                        : 0.f;
        }
        st4(Mt + j * QS + 4 * ti, make_float4(m[0], m[1], m[2], m[3]));
      }
    }
    __syncthreads();

    // (B + C) y = M x + exp(cs) * (C h_prev^T), per 4 x 4 tile of (i, p)
    for (int t = tid; t < QT * PT; t += kThreads) {
      const int ti = t / PT, tp = t % PT;
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < 4 * ti + 4; ++j) {
        float m[4], xv[4];
        unpack(ld4(Mt + j * QS + 4 * ti), m);
        unpack(ld4(xs + j * P + 4 * tp), xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            intra[r][k] = fmaf(m[r], xv[k], intra[r][k]);
      }
      for (int n = 0; n < N; ++n) {
        float c[4], hv[4];
        unpack(ld4(Ct + n * QS + 4 * ti), c);
        unpack(ld4(ht + n * P + 4 * tp), hv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            inter[r][k] = fmaf(c[r], hv[k], inter[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        const float e = ecs[i];
        T* yrow = y + ((size_t)(b * S + s0 + i) * H + h) * P + 4 * tp;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          yrow[k] = from_f32<T>(intra[r][k] + inter[r][k] * e);
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

}  // namespace

// Bytes of shared memory one block needs at (P, N, chunk Q); the wrapper
// refuses shapes that do not fit the card's 227 KB.
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return (long long)smem_bytes(P, N, Q);
}

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for an
// unsupported shape or dtype (dtype: 0 fp32, 1 bf16 for x, B, C and y).
// P, N and Q must be multiples of 4, S a multiple of Q, H of G.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* Bin, const void* Cin, void* y,
                            void* state, int B, int S, int H, int G, int P,
                            int N, int Q, int dtype, void* stream) {
  if (P % 4 || N % 4 || Q % 4 || Q <= 0 || S % Q || G <= 0 || H % G)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  float* st = static_cast<float*>(state);
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
