// Masked LSTM recurrence over a whole window, in one launch.
//
// Replaces the TPU kernel robo_vln_tpu/ops/pallas_lstm.py::_lstm_kernel
// (launched by _pallas_lstm_call).  Per step t, for every batch row b:
//   h, c *= masks[t, b];  g = gates_x[t, b] + h · W_hh
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// with torch's gate order (i, f, g, o).  Outputs outs (T, B, H), hT, cT.
//
// What bounds it on the H100.  The work is small (2·T·B·H·4H FLOP, 0.42 GFLOP
// for T=50, B=4, H=512) and W_hh is 4 MiB in float32, but the T steps are
// sequential: each needs every h of the step before.  So the time is T times
// the latency of one step, not bytes or FLOPs.
//
// What the design does about it.  One persistent cooperative grid (one block
// an SM) runs all T steps.  Block j owns U <= 8 consecutive hidden units (U =
// ceil(H / SMs), so the last block may own fewer: its warps past H idle) and
// keeps the rows of W_hh of all four gates of those units (4U rows, 32 KB at
// H=512, U=4) in registers for the whole window: warp w works on unit
// w mod U, and its lanes hold that unit's four rows, lane l the 16-byte
// chunks l, l+32, ... (KC = ceil(H/128) chunks a row, a template argument).
// A step pays:
//  * one exchange of h.  Each block publishes its units' h as 64-bit words
//    (float bits, step tag) into a workspace buffer, one of two chosen by the
//    step's parity, and the next step reads the whole h back with plain
//    loads, reloading together every word whose tag is not yet the step's.
//    The data is its own flag: there is no grid barrier.  Two buffers are
//    enough, since a block that publishes step t+1 has read all of step t,
//    so every block has finished reading step t-1.
//  * one block barrier, once h is in shared memory (in one of two buffers
//    by step parity, so the next step's copy never meets this step's reads).
//  * one product h · W_hh, h read from shared memory.  A warp task is the
//    four gate rows of the warp's unit by two batch rows (a batch pair); the
//    8/U warps of a unit share its batch pairs.  Each lane sums its chunks,
//    one xor-shuffle tree (a reduce-scatter) sums the lanes' 8 partial dot
//    products, and 4 shuffles bring each cell's four gate sums to its lane.
//  * the cell update, in the same warp: lane 2k+i owns cell (batch row
//    2p+i, the warp's unit) of the warp's k-th task for the whole window and
//    keeps its c in a register.  The mask is applied to the product (m·(h·W) in
//    place of (m·h)·W) and to c, so the h exchange needs no mask.
//    gates_x[t+1] and masks[t+1] are loaded at the end of step t, so those
//    loads are in flight while the step waits for h.  The activations use
//    the hardware exponential and division (about 1e-7 from expf/tanhf).
//
// The tags are epoch + 1 + t, where epoch, in the workspace, counts the steps
// of all earlier launches on it; the last block to finish advances it, so a
// word left by an earlier launch never carries a tag this one waits for.
//
// The C entry points launch on the caller's stream and return a CUDA error
// code (0 on success), or kNotCoResident when the grid cannot be co-resident,
// which a cooperative launch needs.  The shared-memory limit and the
// occupancy query run once per device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaskBatch = 2;      // batch rows of one warp task (with 4 gate rows)
constexpr int kInFlight = 8;       // h words a thread loads before it waits
constexpr int kNotCoResident = 1000;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kMaxSpins = 1 << 24;  // reloads of one word, seconds on the card

typedef unsigned long long u64;

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

__device__ __forceinline__ u64 load_word(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// ws: [epoch, blocks done, then two buffers of B·H tagged words]
template <int KC, bool kExchangeOnly>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_kernel(const float* __restrict__ gates_x,  // (T, B, 4H)
                const float* __restrict__ masks,    // (T, B)
                const float* __restrict__ h0,       // (B, H)
                const float* __restrict__ c0,       // (B, H)
                const float* __restrict__ w_hh_t,   // (4H, H): row = gate*H + unit
                float* __restrict__ outs,           // (T, B, H)
                float* __restrict__ hT,             // (B, H)
                float* __restrict__ cT,             // (B, H)
                u64* ws, int T, int B, int H, int U) {
  extern __shared__ float4 smem4[];
  const int b_pad = (B + kTaskBatch - 1) / kTaskBatch * kTaskBatch;
  float* h_s = reinterpret_cast<float*>(smem4);  // 2 x (b_pad, H); row B stays 0
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * U;
  const int BH = B * H, chunks = H / 4;
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;

  // warp w: unit u = w mod U, batch pairs q, q + Q, ... with q = w / U and
  // Q = kWarps / U warps a unit (warps from Q·U on, and the last block's
  // warps whose unit lies past H, are idle); its lane 2k+i owns the cell
  // (batch row 2(q + Q·k) + i, unit u), so a warp runs at most 16 batch pairs
  const int Q = kWarps / U, u = warp % U, q = warp / U;
  const bool active = q < Q && unit0 + u < H;  // uniform across the warp
  const int pairs = b_pad / kTaskBatch;
  const int cell_b = (q + Q * (lane >> 1)) * kTaskBatch + (lane & 1);
  const bool owner = active && cell_b < B;
  const size_t cell = (size_t)cell_b * H + unit0 + u;

  float4 w[4][KC];  // rows gate·H + unit0 + u of W_hh^T, chunks lane + 32·j
  if (!kExchangeOnly) {
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const float4* row =
          reinterpret_cast<const float4*>(w_hh_t + (size_t)(gate * H + unit0 + u) * H);
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int c = lane + 32 * j;
        w[gate][j] = active && c < chunks ? __ldg(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int i = tid; i < 2 * b_pad * H; i += kThreads)
      h_s[i] = i < BH ? __ldg(h0 + i) : 0.0f;
  }
  float c_reg = 0.0f, gx[4], m = 0.0f;
  if (!kExchangeOnly && owner) c_reg = __ldg(c0 + cell);
  auto prefetch = [&](int t) {
    if (owner) {
      const float* p = gates_x + ((size_t)t * B + cell_b) * 4 * H + unit0 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) gx[g] = __ldg(p + g * H);
      m = __ldg(masks + (size_t)t * B + cell_b);
    }
  };
  if (!kExchangeOnly) prefetch(0);

  for (int t = 0; t < T; ++t) {
    const float* hb_s = h_s + (t & 1) * b_pad * H;
    if (t > 0) {
      // h of step t-1 from every block: kInFlight words at a time, each
      // round reloading together every word not yet tagged with step t-1
      const u64* src = xbuf + (size_t)((t - 1) & 1) * BH;
      const unsigned want = tag0 + (unsigned)(t - 1);
      float* dst_s = h_s + (t & 1) * b_pad * H;
      for (int base = tid; base < BH; base += kThreads * kInFlight) {
        u64 v[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int i = base + j * kThreads;
          v[j] = i < BH ? load_word(src + i) : (u64)want << 32;
        }
        for (int spins = 0;; ++spins) {
          bool ready = true;
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) ready &= (unsigned)(v[j] >> 32) == want;
          if (ready) break;
          if (spins > kMaxSpins) __trap();  // a lost word: fail, never hang
#pragma unroll
          for (int j = 0; j < kInFlight; ++j)
            if ((unsigned)(v[j] >> 32) != want) v[j] = load_word(src + base + j * kThreads);
        }
        if (!kExchangeOnly) {
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            const int i = base + j * kThreads;
            if (i < BH) dst_s[i] = __uint_as_float((unsigned)v[j]);
          }
        }
      }
    }
    __syncthreads();

    // product: lane 2k+i keeps the four gate sums of its cell in g
    float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!kExchangeOnly && active) {
      for (int k = 0, p = q; p < pairs; ++k, p += Q) {
        const float4* hr = reinterpret_cast<const float4*>(hb_s + p * kTaskBatch * H);
        float acc[4 * kTaskBatch];  // acc[gate * 2 + i]
#pragma unroll
        for (int j = 0; j < 4 * kTaskBatch; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int c = lane + 32 * j;
          if (c < chunks) {
            const float4 x0 = hr[c], x1 = hr[chunks + c];
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
              const float4 wv = w[gate][j];
              float& a0 = acc[2 * gate];
              float& a1 = acc[2 * gate + 1];
              a0 = fmaf(wv.x, x0.x, a0);
              a0 = fmaf(wv.y, x0.y, a0);
              a0 = fmaf(wv.z, x0.z, a0);
              a0 = fmaf(wv.w, x0.w, a0);
              a1 = fmaf(wv.x, x1.x, a1);
              a1 = fmaf(wv.y, x1.y, a1);
              a1 = fmaf(wv.z, x1.z, a1);
              a1 = fmaf(wv.w, x1.w, a1);
            }
          }
        }
        // xor tree as a reduce-scatter: at offsets 16, 8, 4 each lane keeps
        // half of its sums and sends the other half, at 2 and 1 it sums
        // its last one; lane l ends with sum (l >> 2) & 7 (9 shuffles, the
        // same additions as a full xor tree of every sum)
#pragma unroll
        for (int n = 4, off = 16; n > 0; n >>= 1, off >>= 1) {
          const bool upper = lane & off;
#pragma unroll
          for (int j = 0; j < n; ++j) {
            const float send = upper ? acc[j] : acc[j + n];
            acc[j] = (upper ? acc[j + n] : acc[j]) +
                     __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
        // gate sum 2·gate + i lies in lanes 4(2·gate + i) .. +3
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const float v = __shfl_sync(0xffffffffu, acc[0], 4 * (2 * gate + (lane & 1)));
          if ((lane >> 1) == k) g[gate] = v;
        }
      }
    }

    // cell update of the lane's cell; publish h for step t+1
    if (owner) {
      float h = 0.0f;
      if (!kExchangeOnly) {
        const float gi = fmaf(m, g[0], gx[0]);
        const float gf = fmaf(m, g[1], gx[1]);
        const float gg = fmaf(m, g[2], gx[2]);
        const float go = fmaf(m, g[3], gx[3]);
        const float c = sigmoid_fast(gf) * (c_reg * m) + sigmoid_fast(gi) * tanh_fast(gg);
        h = sigmoid_fast(go) * tanh_fast(c);
        c_reg = c;
        outs[(size_t)t * BH + cell] = h;
        if (t == T - 1) {
          hT[cell] = h;
          cT[cell] = c;
        }
      }
      if (t < T - 1)
        store_word(xbuf + (size_t)(t & 1) * BH + cell,
                   ((u64)(tag0 + (unsigned)t) << 32) | __float_as_uint(h));
    }
    if (!kExchangeOnly && t < T - 1) prefetch(t + 1);
  }

  // the last block to finish advances the epoch past this launch's tags
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(ws + 1, 1ull) == (u64)(gridDim.x - 1)) {
      ws[1] = 0;
      ws[0] = (u64)(tag0 - 1u + (unsigned)T);
      __threadfence();
    }
  }
}

size_t smem_bytes(int B, int H) {
  const size_t b_pad = (size_t)(B + kTaskBatch - 1) / kTaskBatch * kTaskBatch;
  return 2 * b_pad * H * sizeof(float);
}

// Co-resident blocks of one kernel on one device, found on its first launch
// there: the shared-memory limit raised to kMaxSmem, the SM count and the
// occupancy at kMaxSmem read.  A launch takes at most kMaxSmem (the wrapper
// checks), so at least that many of its blocks are co-resident.
struct Capacity {
  std::once_flag once;
  int blocks = 0;
  cudaError_t err = cudaSuccess;
};

template <int KC, bool kExchangeOnly>
int launch(const void* gates_x, const void* masks, const void* h0, const void* c0,
           const void* w_hh_t, void* outs, void* hT, void* cT, void* ws, int T,
           int B, int H, int U, int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const void* kernel = (const void*)lstm_seq_kernel<KC, kExchangeOnly>;
  Capacity& cap = capacity[dev];
  std::call_once(cap.once, [&] {
    int n_sm = 0, per_sm = 0;
    cap.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem);
    if (cap.err == cudaSuccess)
      cap.err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (cap.err == cudaSuccess)
      cap.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                              kMaxSmem);
    cap.blocks = n_sm * per_sm;
  });
  if (cap.err != cudaSuccess) return (int)cap.err;
  // the exchange-only grid takes the same shared memory, so it lands on the
  // same SMs, one block each
  const size_t smem = smem_bytes(B, H);
  const int blocks = (H + U - 1) / U;
  if (cap.blocks < blocks) return kNotCoResident;
  void* args[] = {&gates_x, &masks, &h0, &c0, &w_hh_t, &outs, &hT, &cT, &ws,
                  &T,       &B,     &H,  &U};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t lstm_seq_smem_bytes(int B, int H) { return smem_bytes(B, H); }

// H a multiple of 4 up to 1024 (KC = 1..8), U <= 8 units a block (ceil(H / U)
// blocks), at most 16 batch pairs a warp (the wrapper checks)
extern "C" int lstm_seq_f32(const void* gates_x, const void* masks, const void* h0,
                            const void* c0, const void* w_hh_t, void* outs, void* hT,
                            void* cT, void* ws, int T, int B, int H, int U, int dev,
                            void* stream) {
#define LSTM_SEQ_KC(kc)                                                             \
  case kc:                                                                          \
    return launch<kc, false>(gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws, T, B, \
                             H, U, dev, stream);
  switch ((H + 127) / 128) {
    LSTM_SEQ_KC(1)
    LSTM_SEQ_KC(2)
    LSTM_SEQ_KC(3)
    LSTM_SEQ_KC(4)
    LSTM_SEQ_KC(5)
    LSTM_SEQ_KC(6)
    LSTM_SEQ_KC(7)
    LSTM_SEQ_KC(8)
  }
#undef LSTM_SEQ_KC
  return (int)cudaErrorInvalidValue;
}

// The same grid running T steps of nothing but the h exchange (h = 0): the
// floor under a step's time that the exchange sets.
extern "C" int lstm_seq_exchange(void* ws, int T, int B, int H, int U, int dev,
                                 void* stream) {
  return launch<1, true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, ws, T, B, H, U, dev, stream);
}
