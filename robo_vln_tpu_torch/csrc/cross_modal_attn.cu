// Unmasked multi-head cross-modal attention: softmax(q·kᵀ/√d_k)·v.
//
// Replaces the TPU kernel robo_vln_tpu/ops/pallas_attention.py::_attn_kernel
// (launched by _pallas_attention), the core of VisualLingAttn's
// MultiHeadAttention: Lq = 200 instruction queries over S = 16 (rgb) or 64
// (depth) visual tokens, h = 4 heads of d_k = d_v = 64, N = B·T examples.
//
// What bounds it on the H100.  Each (example, head) is a tiny product:
// 2·Lq·S·(d_k + d_v) FLOP against Lq·(d_k + d_v) + S·(d_k + d_v) values
// read or written.  At S = 64 in float32 the call moves about 108 MB and does
// 2.6 GFLOP on the CUDA cores, so it sits near the ridge: the bytes of q and
// the output and the float32 FMAs both matter, and the logits must never
// round-trip device memory.
//
// What the design does about it.  Grid (example, head, tile of 32 queries),
// 8 warps a block.  The block stages K and V of its (example, head) in shared
// memory as float32 (at most 64 × 64 × 4 B × 2 = 32 KB), with K's rows padded
// by one float so the lanes of a warp, one key each, hit 32 different banks.
// Each warp takes one query row at a time: its S logits (one key per lane),
// max and sum by warp shuffle, the softmax in registers and shared memory,
// then the d_v outputs (one dimension per lane).  q, k, v and the output are
// read and written once, in the caller's dtype (float32 or bfloat16), and all
// arithmetic is float32.  Heads are addressed by stride in the (N, L, h·d)
// layout, so the caller needs no transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kQueryTile = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cross_modal_attn_kernel(const T* __restrict__ q,  // (N, Lq, h*dk)
                        const T* __restrict__ k,  // (N, S, h*dk)
                        const T* __restrict__ v,  // (N, S, h*dv)
                        T* __restrict__ out,      // (N, Lq, h*dv)
                        int Lq, int S, int heads, int dk, int dv, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, head = blockIdx.y, q0 = blockIdx.z * kQueryTile;
  const int ldk = dk + 1;
  float* k_s = smem;              // (S, dk + 1)
  float* v_s = k_s + S * ldk;     // (S, dv)
  float* q_s = v_s + S * dv;      // (kWarps, dk)
  float* p_s = q_s + kWarps * dk; // (kWarps, S)
  const int Dq = heads * dk, Dv = heads * dv;

  const T* kb = k + (size_t)n * S * Dq + head * dk;
  const T* vb = v + (size_t)n * S * Dv + head * dv;
  for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
    const int s = idx / dk, d = idx - s * dk;
    k_s[s * ldk + d] = to_float(kb[(size_t)s * Dq + d]);
  }
  for (int idx = threadIdx.x; idx < S * dv; idx += blockDim.x) {
    const int s = idx / dv, d = idx - s * dv;
    v_s[idx] = to_float(vb[(size_t)s * Dv + d]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = q_s + warp * dk;
  float* pw = p_s + warp * S;
  for (int r = warp; r < kQueryTile; r += kWarps) {
    const int qi = q0 + r;
    if (qi >= Lq) break;  // uniform across the warp
    const T* qrow = q + ((size_t)n * Lq + qi) * Dq + head * dk;
    for (int d = lane; d < dk; d += 32) qw[d] = to_float(qrow[d]);
    __syncwarp();

    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const float* kr = k_s + s * ldk;
      float a = 0.0f;
      for (int d = 0; d < dk; ++d) a = fmaf(qw[d], kr[d], a);
      a *= scale;
      pw[s] = a;
      mx = fmaxf(mx, a);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(pw[s] - mx);
      pw[s] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.0f / sum;
    __syncwarp();

    T* orow = out + ((size_t)n * Lq + qi) * Dv + head * dv;
    for (int d = lane; d < dv; d += 32) {
      float a = 0.0f;
      for (int s = 0; s < S; ++s) a = fmaf(pw[s] * inv, v_s[s * dv + d], a);
      orow[d] = from_float<T>(a);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int N,
           int Lq, int S, int heads, int dk, int dv, cudaStream_t stream) {
  const size_t smem =
      ((size_t)S * (dk + 1) + (size_t)S * dv + (size_t)kWarps * (dk + S)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cross_modal_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, heads, (Lq + kQueryTile - 1) / kQueryTile);
  cross_modal_attn_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, S, heads, dk, dv,
      1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
extern "C" int cross_modal_attn(const void* q, const void* k, const void* v,
                                void* out, int N, int Lq, int S, int heads,
                                int dk, int dv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  return (int)cudaErrorInvalidValue;
}
