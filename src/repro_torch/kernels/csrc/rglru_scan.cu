// RG-LRU linear scan for Hopper, sm_90a: h_t = a_t * h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (`rglru_scan`,
// body `_rglru_kernel`): a, b (B, S, W) in fp32 or bf16, h (B, S, W)
// always fp32, h_{-1} = 0.  The final state is h[:, S-1].
//
// What bounds it on an H100.  Bytes: each of a, b and h is touched once,
// 12 bytes per element in fp32 (B = 4, S = 512, W = 4096: 100 MB, 30 us at
// 3.35 TB/s; 8 bytes in bf16); 2 flops per element are nothing beside
// that.  To reach the card's rate, the loads in flight must cover its
// memory latency: about 3.35 TB/s * 1 us = 3.4 MB across the card.  The
// TPU kernel tiles (batch, W/block_w, S/block_s) and carries h across the
// sequential time axis in VMEM; carried over as one thread per (b, w)
// column walking all S steps, it runs only B * W threads (4096 at B = 1:
// 32 blocks on 132 SMs), far short of that latency, on an S-step chain.
//
// Design: `rglru_chunked_kernel`, for every S.  One block per (32
// columns, batch row), 8 warps; warp c owns chunk c of each group of
// 8 kChunk-step chunks, lane j column j, so every load and store is 32
// neighbouring columns.  Per group: each thread loads its chunk's a and b
// into registers (all 2 * kChunk loads in flight at once), scans it from
// h = 0 keeping only the chunk's product A_c = prod a_t and end state e_c
// (pass 1), and writes both to shared memory; after one barrier every
// thread folds the group's (A, e) pairs in order from the state entering
// the group, which gives its own chunk's entering state h_in and the
// state leaving the group; then it rescans its chunk from h_in out of the
// same registers and writes h (pass 2).  Every update is a multiply and an
// add rounded separately (no fused multiply-add), as the plain version
// computes it, so within a chunk h is the sequential recurrence's own
// arithmetic (bit for bit for S <= kChunk); only h_in is reassociated.
// a and b are read once and h written once: the bound's 12 bytes per
// element.  At B = 1, W = 4096 this is 128 blocks of 256 threads, each
// thread with 64 loads in flight, and a chain of 2 * kChunk + 8 steps
// per group of 8 * kChunk steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kChunk = 32;            // steps per chunk
constexpr int kChunks = 8;            // chunks per group == warps per block
constexpr int kCols = 32;             // columns per block == warp size
constexpr int kChunkThreads = kChunks * kCols;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T one();
template <> __device__ __forceinline__ float one<float>() { return 1.f; }
template <> __device__ __forceinline__ __nv_bfloat16 one<__nv_bfloat16>() {
  return __float2bfloat16(1.f);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// One block: columns blockIdx.x * 32 .. + 31 of batch row blockIdx.y.
// Steps past S load as a = 1, b = 0, which leave h, A and e unchanged.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads, 2)
rglru_chunked_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ h_out, int S, int W) {
  __shared__ float prod[kChunks][kCols];
  __shared__ float endv[kChunks][kCols];
  const int lane = threadIdx.x % kCols;
  const int c = threadIdx.x / kCols;
  const int w = blockIdx.x * kCols + lane;
  const bool col_ok = w < W;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float carry = 0.f;                      // h entering the group
  for (int g0 = 0; g0 < S; g0 += kChunks * kChunk) {
    const int t0 = g0 + c * kChunk;
    T av[kChunk], bv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (col_ok && t < S) {
        av[u] = a[base + (size_t)t * W];
        bv[u] = b[base + (size_t)t * W];
      } else {
        av[u] = one<T>();
        bv[u] = zero<T>();
      }
    }
    // pass 1: the chunk from h = 0
    float A = 1.f, e = 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float x = to_f32(av[u]);
      e = step(x, e, to_f32(bv[u]));
      A = __fmul_rn(A, x);
    }
    prod[c][lane] = A;
    endv[c][lane] = e;
    __syncthreads();
    // carry: fold the group's chunks in order (every thread the same way)
    float h_in = carry, h = carry;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j == c) h_in = h;
      h = step(prod[j][lane], h, endv[j][lane]);
    }
    carry = h;
    __syncthreads();                      // prod/endv free for the next group
    // pass 2: the chunk again from h_in
    h = h_in;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      h = step(to_f32(av[u]), h, to_f32(bv[u]));
      const int t = t0 + u;
      if (col_ok && t < S) h_out[base + (size_t)t * W] = h;
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, float* h, int B, int S, int W,
           cudaStream_t stream) {
  const dim3 grid((W + kCols - 1) / kCols, B);
  rglru_chunked_kernel<T><<<grid, kChunkThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// dtype this library has no kernel for (dtype of a and b: 0 fp32, 1 bf16).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(h);
  if (B <= 0 || S <= 0 || W <= 0) return -1;
  if (dtype == 0) return launch<float>(a, b, out, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, B, S, W, s);
  return -1;
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
