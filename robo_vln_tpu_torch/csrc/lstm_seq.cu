// Masked LSTM recurrence over a whole window, in one launch.
//
// Replaces the TPU kernel robo_vln_tpu/ops/pallas_lstm.py::_lstm_kernel
// (launched by _pallas_lstm_call).  Per step t, for every batch row b:
//   h, c *= masks[t, b];  g = gates_x[t, b] + h · W_hh
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// with torch's gate order (i, f, g, o).  Outputs outs (T, B, H), hT, cT.
//
// What bounds it on the H100.  The work is small (2·T·B·H·4H FLOP, 0.42 GFLOP
// for T=50, B=4, H=512) and the recurrent weight W_hh is 4 MiB in float32,
// but the T steps are sequential: each needs every h of the step before.  So
// the time is T times the latency of one step, not bytes or FLOPs.
//
// What the design does about it.  One persistent cooperative grid runs all T
// steps.  Block j owns U consecutive hidden units and holds the rows of W_hh
// of all four gates of those units in shared memory for the whole window
// (4·U·H floats, 32 KB at H=512, U=4 on 128 blocks), so the cell update of
// its units needs nothing from other blocks and W_hh is read from device
// memory once.  h crosses between blocks through global memory (outs[t-1],
// read with __ldcg past L1), with one grid-wide barrier per step.  c never
// leaves its owner: the same thread updates the same (b, unit) every step.
// The batch is walked in tiles of 8 rows, so any B >= 1 fits.
//
// The C entry point launches on the caller's stream and returns a CUDA error
// code (0 on success), or kNotCoResident when the grid cannot be co-resident,
// which a cooperative launch needs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBatchTile = 8;
constexpr int kNotCoResident = 1000;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
lstm_seq_kernel(const float* __restrict__ gates_x,  // (T, B, 4H)
                const float* __restrict__ masks,    // (T, B)
                const float* __restrict__ h0,       // (B, H)
                const float* __restrict__ c0,       // (B, H)
                const float* __restrict__ w_hh_t,   // (4H, H): row = gate*H + unit
                float* outs,                        // (T, B, H)
                float* hT,                          // (B, H)
                float* cT,                          // (B, H), also the c carry
                int T, int B, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int R = 4 * U;                     // rows of W_hh this block owns
  float* w_s = smem;                       // (R, H)
  float* h_s = w_s + R * H;                // (kBatchTile, H)
  float* g_s = h_s + kBatchTile * H;       // (kBatchTile, R)
  const int unit0 = blockIdx.x * U;

  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H, k = idx - r * H;
    const int gate = r / U, u = r - gate * U;
    w_s[idx] = w_hh_t[(size_t)(gate * H + unit0 + u) * H + k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : outs + (size_t)(t - 1) * B * H;
    const float* m_t = masks + (size_t)t * B;
    for (int b0 = 0; b0 < B; b0 += kBatchTile) {
      const int nb = min(kBatchTile, B - b0);
      // masked h of the tile's rows, written by every block at step t-1
      for (int idx = threadIdx.x; idx < nb * H; idx += blockDim.x) {
        const int b = idx / H;
        h_s[idx] = __ldcg(h_prev + (size_t)b0 * H + idx) * __ldg(m_t + b0 + b);
      }
      __syncthreads();
      // one warp per (row of the tile, gate row of this block): h · W_hh
      for (int p = warp; p < nb * R; p += nwarps) {
        const int b = p / R, r = p - b * R;
        const float* wr = w_s + r * H;
        const float* hb = h_s + b * H;
        float acc = 0.0f;
        for (int k = lane; k < H; k += 32) acc = fmaf(wr[k], hb[k], acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) {
          const int gate = r / U, u = r - gate * U;
          g_s[b * R + r] =
              acc + __ldg(gates_x + ((size_t)t * B + b0 + b) * 4 * H +
                          gate * H + unit0 + u);
        }
      }
      __syncthreads();
      // cell update of this block's units
      for (int idx = threadIdx.x; idx < nb * U; idx += blockDim.x) {
        const int b = idx / U, u = idx - b * U;
        const size_t o = (size_t)(b0 + b) * H + unit0 + u;
        const float* g = g_s + b * R;
        const float c_prev = (t == 0 ? c0[o] : cT[o]) * __ldg(m_t + b0 + b);
        const float c = sigmoidf(g[U + u]) * c_prev +
                        sigmoidf(g[u]) * tanhf(g[2 * U + u]);
        const float h = sigmoidf(g[3 * U + u]) * tanhf(c);
        cT[o] = c;
        outs[(size_t)t * B * H + o] = h;
        if (t == T - 1) hT[o] = h;
      }
      __syncthreads();
    }
    grid.sync();
  }
}

}  // namespace

extern "C" size_t lstm_seq_smem_bytes(int H, int U) {
  return ((size_t)4 * U * H + (size_t)kBatchTile * H + (size_t)kBatchTile * 4 * U) *
         sizeof(float);
}

extern "C" int lstm_seq_f32(const void* gates_x, const void* masks,
                            const void* h0, const void* c0, const void* w_hh_t,
                            void* outs, void* hT, void* cT, int T, int B, int H,
                            int U, void* stream) {
  const size_t smem = lstm_seq_smem_bytes(H, U);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_seq_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int blocks = H / U;
  if (per_sm * n_sm < blocks) return kNotCoResident;

  const float* a_gx = static_cast<const float*>(gates_x);
  const float* a_m = static_cast<const float*>(masks);
  const float* a_h0 = static_cast<const float*>(h0);
  const float* a_c0 = static_cast<const float*>(c0);
  const float* a_w = static_cast<const float*>(w_hh_t);
  float* a_outs = static_cast<float*>(outs);
  float* a_hT = static_cast<float*>(hT);
  float* a_cT = static_cast<float*>(cT);
  void* args[] = {&a_gx, &a_m, &a_h0, &a_c0, &a_w, &a_outs, &a_hT, &a_cT,
                  &T,    &B,   &H,    &U};
  err = cudaLaunchCooperativeKernel((const void*)lstm_seq_kernel, dim3(blocks),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
