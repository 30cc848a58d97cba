// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): causal / sliding-window GQA
// attention forward with an online softmax kept in fp32.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), out (B, Sq, H, D), all
// contiguous, fp32 or bf16; query head h reads KV head h / (H / Hkv).
//
// Design.  One block per (64-row Q tile, head, batch).  The TPU kernel
// carries m/l/acc in VMEM scratch across a sequential KV grid axis; here a
// loop inside the block walks the KV tiles instead, and it visits only the
// tiles that the causal and window masks leave visible, so masked work is
// skipped as on the TPU.  K and V tiles (32 rows) are staged through
// shared memory as fp32; each query row is owned by 4 neighbouring lanes
// of one warp, which split the row's 32 scores and its D output columns,
// so the row's softmax reductions are two shuffles and the row's
// probabilities never leave the warp.  Masking uses the finite constant
// -0.7 * FLT_MAX of the TPU kernel: a row whose first visible tile is fully
// masked for it accumulates exp(0) = 1 terms that the first real score
// wipes out with alpha = exp(NEG_INF - m) = 0, where -inf would give NaN.
//
// What bounds it on an H100.  At the serving shapes (S = 512..1024,
// D = 256, 4 query heads on 1 KV head) the card's own bound is a few
// microseconds either way: 4 * B * H * D * S^2 / 2 flops against
// 2 * B * S * (H + Hkv) * D elements moved, about 50 flops per bf16 byte,
// below the ~295 at which the tensor cores rather than memory limit.
// This kernel computes on the fp32 CUDA cores (67 TFLOP/s peak) and is
// limited by issuing shared-memory loads, so the inner products read q,
// k, v and p as 16-byte vectors (rows padded to keep them aligned and the
// banks distinct) and each lane owns 4-column groups of the output.  At
// D = 256 its 139 KB of shared memory allows one block per SM.  wgmma
// with TMA loads is the later work that reaches the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

}  // namespace

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// head dim / dtype this kernel is not built for.  dtype: 0 fp32, 1 bf16.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
