// RG-LRU linear scan for Hopper, sm_90a: h_t = a_t * h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (`rglru_scan`,
// body `_rglru_kernel`): a, b (B, S, W) in fp32 or bf16, h (B, S, W)
// always fp32, h_{-1} = 0.  The final state is h[:, S-1].
//
// Design.  The TPU kernel tiles (batch, W/block_w, S/block_s) and carries
// h across the sequential time axis in VMEM.  Here one thread owns one
// (b, w) column and walks all S steps with h in a register, so no state
// crosses blocks.  Neighbouring threads own neighbouring w, so every
// load of a and b and every store of h is coalesced along W.  Loads for
// kUnroll steps are issued before the dependent chain of updates uses
// them, keeping 2 * kUnroll loads in flight per thread.  Each update is
// a multiply and an add rounded separately (no fused multiply-add), as
// the plain version computes it.
//
// What bounds it on an H100.  Bytes: each of a, b and h is touched once,
// 12 bytes per element in fp32 (B = 4, S = 512, W = 4096: 100 MB, 30 us at
// 3.35 TB/s); 2 flops per element are nothing beside that.  With one
// thread per column there are only B * W = 16k threads, so the loads in
// flight (2 * kUnroll each) fall short of what the card's latency needs
// for its full rate: splitting S into chunks with a second pass (a
// chunked scan) is the later work that fills the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One thread: column w = blockIdx.x * kThreads + threadIdx.x of batch row
// blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             float* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_f32(a[base + (size_t)(t + u) * W]);
      bv[u] = to_f32(b[base + (size_t)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      h_out[base + (size_t)(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t off = base + (size_t)t * W;
    h = __fadd_rn(__fmul_rn(to_f32(a[off]), h), to_f32(b[off]));
    h_out[off] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, float* h, int B, int S, int W,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// dtype this kernel is not built for (dtype of a and b: 0 fp32, 1 bf16).
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
