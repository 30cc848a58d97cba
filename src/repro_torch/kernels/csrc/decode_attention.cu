// Flash-decode for Hopper, sm_90a: one query token against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (`decode_attention`, body `_decode_kernel`): q (B, 1, H, D) against
// caches (B, S, Hkv, D) with cache positions >= lengths[b] masked, online
// softmax in fp32, fp32 or bf16 storage.
//
// Design.  The TPU kernel walks the cache length as a sequential grid
// axis, one batch row per core.  On an H100 that would leave all but B
// of 132 SMs idle, so the cache length is split (flash-decoding): one
// block per (split, KV head, batch row) walks its chunk of the cache in
// 32-row tiles and keeps m / l / acc for the `rep = H / Hkv` query heads
// of its GQA group together, so each K/V tile is read from device memory
// once for the whole group, as the TPU kernel's (Hkv, rep, D) reshape
// does.  Chunks past lengths[b] read nothing.  Each split writes its
// partial (m, l, acc) to a workspace, and a second kernel combines the
// splits with the same algebra the online softmax uses within one
// (weights exp(m_s - max m)).  With one split the first kernel writes
// the output itself.  Inside a tile one warp per query head reduces the
// tile's 32 scores with shuffles (lane = KV row).  The mask constant is
// the TPU kernel's finite -0.7 * FLT_MAX and l is clamped at 1e-30, as
// there; an empty split's m stays at that constant, so its weight in the
// combine is exp(-huge) = 0.
//
// What bounds it on an H100.  A decode step reads each valid cache row
// once: 2 tensors * Hkv * D * bytes per row, e.g. 3.5 MB for B = 8 rows of
// mixed length (sum 3,463) at D = 256 in bf16 -- about 1 us at 3.35 TB/s,
// less than a kernel launch.  The bound that matters in serving is the
// launch and the host that enqueues it; the splits keep the device part
// short by spreading the rows over the SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * FLT_MAX
constexpr int kTile = 32;        // KV rows per tile == warp size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSS = kTile + 1;   // padded stride of the score tile

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int rep, int D) {
  // q (rep x D), k (tile x D+1), v (tile x D), scores (rep x tile+1),
  // acc (rep x D), m / l / alpha (rep each)
  return sizeof(float) * ((size_t)rep * D + kTile * (D + 1) + kTile * D +
                          (size_t)rep * kSS + (size_t)rep * D + 3 * rep);
}

// One block: split blockIdx.x of KV head blockIdx.y of batch row
// blockIdx.z.  With ws == nullptr (one split) it writes the normalized
// output; otherwise the split's partial, (rep, D + 2) floats per split:
// acc[0..D), m, l.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ ws, int S, int H,
              int Hkv, int chunk, float scale) {
  static_assert(kTile * D % kThreads == 0, "tile loads must split evenly");
  constexpr int DP = D + 1;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                 // rep x D
  float* ks = qs + rep * D;         // kTile x DP
  float* vs = ks + kTile * DP;      // kTile x D
  float* ss = vs + kTile * D;       // rep x kSS
  float* accs = ss + rep * kSS;     // rep x D
  float* ms = accs + rep * D;       // rep
  float* ls = ms + rep;             // rep
  float* as = ls + rep;             // rep

  const int start = split * chunk;
  const int end = min(start + chunk, min(lengths[b], S));
  // the group's query heads hk*rep .. hk*rep+rep-1 are contiguous
  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) {
    qs[i] = to_f32(q[q_off + i]);
    accs[i] = 0.f;
  }
  for (int i = tid; i < rep; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  for (int k_lo = start; k_lo < end; k_lo += kTile) {
    __syncthreads();  // previous tile fully consumed; init visible
    // a compile-time trip count lets every load of the tile be in flight
    // at once (kTile * D is a multiple of kThreads for every D built)
#pragma unroll
    for (int j = 0; j < kTile * D / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / D, d = i % D;
      const int s = k_lo + r;
      float kx = 0.f, vx = 0.f;
      if (s < end) {
        const size_t off = ((size_t)(b * S + s) * Hkv + hk) * D + d;
        kx = to_f32(kc[off]);
        vx = to_f32(vc[off]);
      }
      ks[r * DP + d] = kx;
      vs[r * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile, kk = i % kTile;
      const float* qrow = qs + r * D;
      const float* krow = ks + kk * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
      ss[r * kSS + kk] = (k_lo + kk < end) ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kWarps) {
      const float m_prev = ms[r];
      const float l_prev = ls[r];
      const float sc = ss[r * kSS + lane];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = expf(sc - m_new);
      const float psum = warp_sum(p);
      ss[r * kSS + lane] = p;
      __syncwarp();  // every lane has read m/l before lane 0 writes them
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[r] = alpha;
        ls[r] = l_prev * alpha + psum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < rep * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const float* prow = ss + r * kSS;
      float a = accs[i] * as[r];
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) a = fmaf(prow[kk], vs[kk * D + c], a);
      accs[i] = a;
    }
  }
  __syncthreads();

  if (ws == nullptr) {
    for (int i = tid; i < rep * D; i += kThreads) {
      const int r = i / D;
      o[q_off + i] = from_f32<T>(accs[i] / fmaxf(ls[r], 1e-30f));
    }
    return;
  }
  float* part = ws + ((size_t)(b * Hkv + hk) * gridDim.x + split) * rep *
                         (D + 2);
  for (int i = tid; i < rep * D; i += kThreads)
    part[(i / D) * (D + 2) + i % D] = accs[i];
  for (int r = tid; r < rep; r += kThreads) {
    part[r * (D + 2) + D] = ms[r];
    part[r * (D + 2) + D + 1] = ls[r];
  }
}

// Combine the n_split partials of one (KV head, batch row) into the output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, T* __restrict__ o, int H,
               int Hkv, int D, int n_split) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hkv;
  const size_t stride = (size_t)rep * (D + 2);      // one split's partial
  const float* base = ws + (size_t)(b * Hkv + hk) * n_split * stride;
  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * D;
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, base[s * stride + r * (D + 2) + D]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = base + s * stride + r * (D + 2);
      const float w = expf(p[D] - m);
      l = fmaf(p[D + 1], w, l);
      acc = fmaf(p[c], w, acc);
    }
    o[q_off + i] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* ws, int n_split, int B, int S, int H, int Hkv,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  auto kernel = decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // chunk: a multiple of the tile that covers S in n_split pieces
  const int chunk = ((S + n_split - 1) / n_split + kTile - 1) / kTile * kTile;
  const dim3 grid(n_split, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o),
      n_split > 1 ? ws : nullptr, S, H, Hkv, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  combine_kernel<T><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      ws, static_cast<T*>(o), H, Hkv, D, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, void* o, float* ws, int n_split, int B,
               int S, int H, int Hkv, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, lengths, o, ws, n_split, B, S, H, Hkv, scale, s);
    case 16: return launch<T, 16>(q, k, v, lengths, o, ws, n_split, B, S, H, Hkv, scale, s);
    case 32: return launch<T, 32>(q, k, v, lengths, o, ws, n_split, B, S, H, Hkv, scale, s);
    case 64: return launch<T, 64>(q, k, v, lengths, o, ws, n_split, B, S, H, Hkv, scale, s);
    case 128: return launch<T, 128>(q, k, v, lengths, o, ws, n_split, B, S, H, Hkv, scale, s);
    case 256: return launch<T, 256>(q, k, v, lengths, o, ws, n_split, B, S, H, Hkv, scale, s);
    default: return -1;
  }
}

}  // namespace

// Bytes of shared memory one block needs; the wrapper refuses a group
// that does not fit the card's 227 KB.
extern "C" long long decode_attention_smem_bytes(int rep, int D) {
  return (long long)smem_bytes(rep, D);
}

// Returns 0 on success, the cudaError_t of a refused launch, or -1 for a
// head dim / dtype this kernel is not built for.  dtype: 0 fp32, 1 bf16.
// ws: n_split * B * Hkv * rep * (D + 2) floats (unused when n_split == 1).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* ws, int n_split, int B,
                                    int S, int H, int Hkv, int D,
                                    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  if (n_split < 1) return -1;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, len, o, w, n_split, B, S, H, Hkv, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, w, n_split, B, S, H, Hkv, scale, s);
  return -1;
}

// Message of a cudaError_t returned by the launch entry above.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
