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
// The backward has two kernels over the same grid, run in reverse over the
// window: lstm_seq_backward_kernel (below), which exchanges each step's
// whole dg, and lstm_seq_backward_partials_kernel, which exchanges partial
// sums of dh~ and is the route; their notes say what differs.  Each kernel
// also runs as its grid with nothing but its exchange (kExchangeOnly), to
// measure the floor that the exchange puts under a step.
//
// Past H = 1024 or 8 units a block, the wide kernels run the same grid
// with W_hh split between registers, shared memory and a ring of tensor
// copies from L2 (lstm_seq_wide_kernel and
// lstm_seq_backward_partials_wide_kernel, the backward's blocks in clusters
// that sum their partials; their note says how; the direct
// lstm_seq_wide_direct_kernel takes the forward where h does not fit in
// shared memory beside the ring).  H off a multiple of 4 is padded by the
// wrapper, so every H has a route.
//
// The C entry points launch on the caller's stream and return a CUDA error
// code (0 on success), or kNotCoResident when the grid cannot be co-resident,
// which a cooperative launch needs.  The shared-memory limit and the
// occupancy query run once per device.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaskBatch = 2;      // batch rows of one warp task (with 4 gate rows)
constexpr int kInFlight = 8;       // h words a thread loads before it waits
constexpr int kBwdInFlight = 16;   // the backward's dg words a thread loads before it waits
constexpr int kSweep = 8;          // steps of the backward's c_t sweep loaded at a time
constexpr int kMaxUnits = 8;       // units a block of the partials kernel
constexpr int kPartialsInFlight = 16;  // partials a lane loads before it waits
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

// The backward: the VJP of the masked recurrence with respect to gates_x,
// h0, c0 (and, through the wrapper, masks and W_hh), the function that the
// JAX package's custom_vjp _bwd (pallas_lstm.py:162-165) gets by
// differentiating its scan.  With h~_t = m_t h_{t-1}, c~_t = m_t c_{t-1},
// g_t = gx_t + h~_t W_hh (recomputed by the wrapper for all T steps in one
// product and passed as `gates`) and i, f, gg, o its activations, from
// t = T-1 down to 0:
//   dh = g_outs[t] + m_{t+1} dh~_{t+1},  dc = m_{t+1} dc~_{t+1} + dh o (1 - tanh^2 c_t)
//   dg_t = (dc gg i(1-i), dc c~_t f(1-f), dc i (1-gg^2), dh tanh(c_t) o(1-o))
//   dh~_t = dg_t · W_hh^T,  dc~_t = dc f
// where m_T dh~_T and m_T dc~_T stand for g_hT and g_cT.  Outputs dg
// (= d gates_x), d_h0 = m_0 dh~_0, d_c0 = m_0 dc~_0, c_t (T, B, H) and, when
// the wrapper asks (non-null pointers), dh~ and dc~ (T, B, H), from which it
// forms the masks' gradient; it forms d_W_hh = sum_t h~_t^T dg_t in one
// product.
//
// What bounds it is what bounds the forward: T sequential steps, each of
// which needs the whole dg of the step after (B·4H values, 4x the forward's
// h) before it can form dh~.  The design is the forward's grid with W_hh's
// roles transposed.  Block j owns the same U units v, and warp w's lanes
// hold the row W_hh[v, :] of its unit (4H values: the four gate segments of
// H, lane l the 16-byte chunks l, l+32, ... of each, the same registers as
// the forward's four rows).  A step (a stage s = T-1-t of the loop) pays:
//  * one exchange of dg: each block publishes its cells' four dg values as
//    (float bits, step tag) words into one of two buffers of B·4H words by
//    the stage's parity, and every block reads the whole dg back into shared
//    memory, reloading every word not yet tagged, as the forward does with h;
//  * one block barrier, then dh~ of the warp's unit for two batch rows (a
//    task): each lane sums its chunks over the four gate segments, and one
//    xor-shuffle tree (a reduce-scatter over the two rows at offset 16) sums
//    the lanes;
//  * the cell update in the lane that owns the cell (the forward's lane
//    layout), whose dh and dc carries stay in registers.
// c_t is not an output of the forward, so before the loop the owner of each
// cell recomputes it by a forward sweep over t, elementwise from `gates`
// (kSweep steps' loads at a time), into cs; the loop reads it back.  A
// step's inputs (gates, g_outs, the mask, c_{t-1}) are loaded at the end of
// the step before, while the exchange waits.  Tags and the epoch work as in
// the forward: this launch's tags are epoch + 1 + s, and the last block to
// finish advances the epoch by T, so the two kernels share one workspace.
template <int KC, bool kExchangeOnly>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_backward_kernel(const float* __restrict__ gates,   // (T, B, 4H) pre-activations
                         const float* __restrict__ masks,   // (T, B)
                         const float* __restrict__ c0,      // (B, H)
                         const float* __restrict__ w_hh,    // (H, 4H)
                         const float* __restrict__ g_outs,  // (T, B, H)
                         const float* __restrict__ g_hT,    // (B, H)
                         const float* __restrict__ g_cT,    // (B, H)
                         float* __restrict__ d_gates,       // (T, B, 4H)
                         float* __restrict__ d_h0,          // (B, H)
                         float* __restrict__ d_c0,          // (B, H)
                         float* cs,                         // (T, B, H): c_t
                         float* __restrict__ d_h_tilde,     // (T, B, H) or null
                         float* __restrict__ d_c_tilde,     // (T, B, H) or null
                         u64* ws, int T, int B, int H, int U) {
  extern __shared__ float4 smem4[];
  const int b_pad = (B + kTaskBatch - 1) / kTaskBatch * kTaskBatch;
  const int G = 4 * H;  // a row of dg
  float* dg_s = reinterpret_cast<float*>(smem4);  // 2 x (b_pad, 4H); row B stays 0
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * U;
  const int BH = B * H, BG = B * G, chunks = H / 4;
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;

  // the forward's layout: warp w on unit w mod U, lane 2k+i owning the cell
  // (batch row 2(q + Q·k) + i, unit u) of its k-th task
  const int Q = kWarps / U, u = warp % U, q = warp / U;
  const bool active = q < Q && unit0 + u < H;  // uniform across the warp
  const int pairs = b_pad / kTaskBatch;
  const int cell_b = (q + Q * (lane >> 1)) * kTaskBatch + (lane & 1);
  const bool owner = active && cell_b < B;
  const size_t cell = (size_t)cell_b * H + unit0 + u;   // in a (B, H) slab
  const size_t gcell = (size_t)cell_b * G + unit0 + u;  // its gate 0 in a (B, 4H) slab

  for (int i = tid; i < 2 * b_pad * G; i += kThreads) dg_s[i] = 0.0f;

  // c_t of the lane's cell, t = 0 .. T-1, into cs
  float c = 0.0f;
  if (!kExchangeOnly && owner) {
    c = __ldg(c0 + cell);
    for (int t0 = 0; t0 < T; t0 += kSweep) {
      float gx[kSweep][3], m[kSweep];
#pragma unroll
      for (int k = 0; k < kSweep; ++k) {
        const int t = min(t0 + k, T - 1);
        const float* p = gates + (size_t)t * BG + gcell;
#pragma unroll
        for (int g = 0; g < 3; ++g) gx[k][g] = __ldg(p + g * H);
        m[k] = __ldg(masks + (size_t)t * B + cell_b);
      }
#pragma unroll
      for (int k = 0; k < kSweep; ++k) {
        if (t0 + k < T) {
          c = sigmoid_fast(gx[k][1]) * (c * m[k]) + sigmoid_fast(gx[k][0]) * tanh_fast(gx[k][2]);
          cs[(size_t)(t0 + k) * BH + cell] = c;
        }
      }
    }
  }

  float4 w[4][KC];  // W_hh[unit0 + u, gate·H + 4c .. 4c + 3], c = lane + 32·j
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    const float4* row =
        reinterpret_cast<const float4*>(w_hh + (size_t)(unit0 + u) * G + gate * H);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int cc = lane + 32 * j;
      w[gate][j] = !kExchangeOnly && active && cc < chunks ? __ldg(row + cc)
                                                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // the owner's carries: m_{t+1} dh~_{t+1} and m_{t+1} dc~_{t+1} (g_hT and g_cT
  // at t = T-1), dc~ and the mask of the step after, c_t
  float dh_carry = 0.0f, dc_carry = 0.0f, dc_tilde = 0.0f, m_next = 0.0f, c_t = c;
  if (!kExchangeOnly && owner) {
    dh_carry = __ldg(g_hT + cell);
    dc_carry = __ldg(g_cT + cell);
  }
  // step t's inputs, and c_{t-1}
  float pg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pgo = 0.0f, pm = 0.0f, pcp = 0.0f;
  auto prefetch = [&](int t) {
    if (!kExchangeOnly && owner) {
      const float* p = gates + (size_t)t * BG + gcell;
#pragma unroll
      for (int g = 0; g < 4; ++g) pg[g] = __ldg(p + g * H);
      pgo = __ldg(g_outs + (size_t)t * BH + cell);
      pm = __ldg(masks + (size_t)t * B + cell_b);
      pcp = t > 0 ? cs[(size_t)(t - 1) * BH + cell] : __ldg(c0 + cell);  // cs: this thread's stores
    }
  };
  prefetch(T - 1);

  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;
    const float* db_s = dg_s + (s & 1) * b_pad * G;
    if (s > 0) {
      // dg of step t+1 from every block, kBwdInFlight words at a time
      const u64* src = xbuf + (size_t)((s - 1) & 1) * BG;
      const unsigned want = tag0 + (unsigned)(s - 1);
      float* dst_s = dg_s + (s & 1) * b_pad * G;
      for (int base = tid; base < BG; base += kThreads * kBwdInFlight) {
        u64 v[kBwdInFlight];
#pragma unroll
        for (int j = 0; j < kBwdInFlight; ++j) {
          const int i = base + j * kThreads;
          v[j] = i < BG ? load_word(src + i) : (u64)want << 32;
        }
        for (int spins = 0;; ++spins) {
          bool ready = true;
#pragma unroll
          for (int j = 0; j < kBwdInFlight; ++j) ready &= (unsigned)(v[j] >> 32) == want;
          if (ready) break;
          if (spins > kMaxSpins) __trap();  // a lost word: fail, never hang
#pragma unroll
          for (int j = 0; j < kBwdInFlight; ++j)
            if ((unsigned)(v[j] >> 32) != want) v[j] = load_word(src + base + j * kThreads);
        }
        if (!kExchangeOnly) {
#pragma unroll
          for (int j = 0; j < kBwdInFlight; ++j) {
            const int i = base + j * kThreads;
            if (i < BG) dst_s[i] = __uint_as_float((unsigned)v[j]);
          }
        }
      }
    }
    __syncthreads();

    if (!kExchangeOnly && s > 0) {
      // dh~_{t+1} = dg_{t+1} · W_hh^T for the lane's cell
      float dht = 0.0f;
      if (active) {
        for (int k = 0, p = q; p < pairs; ++k, p += Q) {
          const float4* r0 = reinterpret_cast<const float4*>(db_s + (size_t)p * kTaskBatch * G);
          const float4* r1 = r0 + H;  // the next batch row: 4H floats on
          float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const int cc = lane + 32 * j;
            if (cc < chunks) {
#pragma unroll
              for (int gate = 0; gate < 4; ++gate) {
                const float4 wv = w[gate][j];
                const float4 x0 = r0[gate * chunks + cc], x1 = r1[gate * chunks + cc];
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
          // xor tree as a reduce-scatter: at offset 16 each lane keeps one
          // row's sum and sends the other; lanes 0-15 end with row 0's,
          // 16-31 with row 1's (the additions of a full xor tree)
          const bool upper = lane & 16;
          float acc = (upper ? a1 : a0) + __shfl_xor_sync(0xffffffffu, upper ? a0 : a1, 16);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          const float v = __shfl_sync(0xffffffffu, acc, 16 * (lane & 1));
          if ((lane >> 1) == k) dht = v;
        }
      }
      if (owner) {
        if (d_h_tilde) d_h_tilde[(size_t)(t + 1) * BH + cell] = dht;
        dh_carry = m_next * dht;
        dc_carry = m_next * dc_tilde;
      }
    }
    if (s == T) break;

    // step t of the lane's cell; publish its dg for the step before
    if (kExchangeOnly && owner) {
      u64* dst = xbuf + (size_t)(s & 1) * BG + gcell;
      const u64 tag = (u64)(tag0 + (unsigned)s) << 32;
#pragma unroll
      for (int g = 0; g < 4; ++g) store_word(dst + g * H, tag);
    } else if (owner) {
      const float ig = sigmoid_fast(pg[0]), fg = sigmoid_fast(pg[1]);
      const float gg = tanh_fast(pg[2]), og = sigmoid_fast(pg[3]);
      const float tc = tanh_fast(c_t);
      const float dh = pgo + dh_carry;
      const float dc = dc_carry + dh * og * (1.0f - tc * tc);
      const float dg[4] = {dc * gg * ig * (1.0f - ig), dc * (pcp * pm) * fg * (1.0f - fg),
                           dc * ig * (1.0f - gg * gg), dh * tc * og * (1.0f - og)};
      float* out = d_gates + (size_t)t * BG + gcell;
      u64* dst = xbuf + (size_t)(s & 1) * BG + gcell;
      const u64 tag = (u64)(tag0 + (unsigned)s) << 32;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        out[g * H] = dg[g];
        store_word(dst + g * H, tag | __float_as_uint(dg[g]));
      }
      dc_tilde = dc * fg;
      if (d_c_tilde) d_c_tilde[(size_t)t * BH + cell] = dc_tilde;
      m_next = pm;
      c_t = pcp;
    }
    if (t > 0) prefetch(t - 1);
  }
  if (!kExchangeOnly && owner) {
    d_h0[cell] = dh_carry;
    d_c0[cell] = dc_carry;
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

// The backward that exchanges partial sums, the route of the backward
// (lstm_seq_backward_kernel above stays, for a forced comparison): the same
// VJP, outputs, c_t sweep, step inputs, tags and epoch; what crosses the
// grid differs.  The kernel above is held by its exchange: every block
// reads the whole dg of the step after, B·4H tagged words (32 words a
// thread in two dependent rounds at B = 4, H = 512; 8 MiB of L2 reads a
// step over the grid), 4x the words of the forward's h.  Here dh~ = dg ·
// W_hh^T is cut by W_hh's columns.  Block j holds the columns gate·H + v of
// its U units v, the rows of W_hh^T that the forward holds (thread tid their
// entries k = tid + 256·i, i < KPT, in registers), and once its cells' dg
// of a step are in shared memory it forms, for every batch row b and every
// unit k, its partial sum over those 4U columns
//   P_j[b, k] = Σ_gate Σ_u dg[b, gate·H + unit0 + u] · W_hh[k, gate·H + unit0 + u]
// (gate by gate, unit by unit, in one float32 register) and publishes it
// as B·H tagged words (coalesced stores; 2 MiB a step over the grid at B =
// 4, H = 512).  The owner of cell (b, v) then needs only the partials of v,
// one from every block: U·B words a block and step (as many as the
// forward's h), and those of one row of one block lie side by side.  Warp w
// reads the rows w, w + 8, ...: lane l the words of unit u = l mod U_p (U
// rounded up to a power of 2) from blocks l / U_p + G·r, r = 0, 1, ... (G =
// 32 / U_p lanes a unit), kPartialsInFlight at a time, reloading together
// every word not yet tagged; it sums them in r's order, and an xor-shuffle
// tree over the G lanes of a unit (offsets 16, 8, ..., U_p) sums the blocks.
// Lane u + U_p·i of warp w owns the cell (row w + 8i, unit unit0 + u), so a
// launch takes up to 8·G rows.  A step pays one exchange of the forward's
// size plus the partials' stores, one block barrier (between the owners'
// dg in shared memory and the partials) and B·4U multiply-adds per unit k.
template <int KPT, bool kExchangeOnly>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_backward_partials_kernel(const float* __restrict__ gates,   // (T, B, 4H) pre-activations
                                  const float* __restrict__ masks,   // (T, B)
                                  const float* __restrict__ c0,      // (B, H)
                                  const float* __restrict__ w_hh_t,  // (4H, H)
                                  const float* __restrict__ g_outs,  // (T, B, H)
                                  const float* __restrict__ g_hT,    // (B, H)
                                  const float* __restrict__ g_cT,    // (B, H)
                                  float* __restrict__ d_gates,       // (T, B, 4H)
                                  float* __restrict__ d_h0,          // (B, H)
                                  float* __restrict__ d_c0,          // (B, H)
                                  float* cs,                         // (T, B, H): c_t
                                  float* __restrict__ d_h_tilde,     // (T, B, H) or null
                                  float* __restrict__ d_c_tilde,     // (T, B, H) or null
                                  u64* ws, int T, int B, int H, int U) {
  extern __shared__ float4 smem4[];
  // the block's cells' dg by stage parity: 2 x (B, 4 gates, kMaxUnits), zero
  // past U and past H
  float* dg_s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blocks = gridDim.x, unit0 = blockIdx.x * U;
  const int BH = B * H, G = 4 * H;
  const size_t slab = (size_t)blocks * BH;  // one buffer of partials: (blocks, B, H)
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;

  int up = 1;  // U rounded up to a power of 2
  while (up < U) up <<= 1;
  const int lanes = 32 / up;  // lanes of one unit
  const int u = lane & (up - 1), sub = lane / up;
  const bool unit_ok = u < U && unit0 + u < H;
  const int rows = warp < B ? (B - 1 - warp) / kWarps + 1 : 0;  // the warp's rows
  const int cell_b = warp + kWarps * sub;
  const bool owner = unit_ok && sub < rows;
  const size_t cell = (size_t)cell_b * H + unit0 + u;   // in a (B, H) slab
  const size_t gcell = (size_t)cell_b * G + unit0 + u;  // its gate 0 in a (B, 4H) slab

  for (int i = tid; i < 2 * B * 4 * kMaxUnits; i += kThreads) dg_s[i] = 0.0f;
  __syncthreads();  // before any owner writes its cells' dg

  // c_t of the lane's cell, t = 0 .. T-1, into cs
  float c = 0.0f;
  if (!kExchangeOnly && owner) {
    c = __ldg(c0 + cell);
    for (int t0 = 0; t0 < T; t0 += kSweep) {
      float gx[kSweep][3], m[kSweep];
#pragma unroll
      for (int k = 0; k < kSweep; ++k) {
        const int t = min(t0 + k, T - 1);
        const float* p = gates + (size_t)t * B * G + gcell;
#pragma unroll
        for (int g = 0; g < 3; ++g) gx[k][g] = __ldg(p + g * H);
        m[k] = __ldg(masks + (size_t)t * B + cell_b);
      }
#pragma unroll
      for (int k = 0; k < kSweep; ++k) {
        if (t0 + k < T) {
          c = sigmoid_fast(gx[k][1]) * (c * m[k]) + sigmoid_fast(gx[k][0]) * tanh_fast(gx[k][2]);
          cs[(size_t)(t0 + k) * BH + cell] = c;
        }
      }
    }
  }

  float w[KPT][4][kMaxUnits];  // W_hh^T[gate·H + unit0 + u, tid + kThreads·i]
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = tid + kThreads * i;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int uu = 0; uu < kMaxUnits; ++uu)
        w[i][gate][uu] = !kExchangeOnly && k < H && uu < U && unit0 + uu < H
                             ? __ldg(w_hh_t + (size_t)(gate * H + unit0 + uu) * H + k)
                             : 0.0f;
  }

  // the owner's carries, as in the kernel above
  float dh_carry = 0.0f, dc_carry = 0.0f, dc_tilde = 0.0f, m_next = 0.0f, c_t = c;
  if (!kExchangeOnly && owner) {
    dh_carry = __ldg(g_hT + cell);
    dc_carry = __ldg(g_cT + cell);
  }
  // step t's inputs, and c_{t-1}
  float pg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pgo = 0.0f, pm = 0.0f, pcp = 0.0f;
  auto prefetch = [&](int t) {
    if (!kExchangeOnly && owner) {
      const float* p = gates + (size_t)t * B * G + gcell;
#pragma unroll
      for (int g = 0; g < 4; ++g) pg[g] = __ldg(p + g * H);
      pgo = __ldg(g_outs + (size_t)t * BH + cell);
      pm = __ldg(masks + (size_t)t * B + cell_b);
      pcp = t > 0 ? cs[(size_t)(t - 1) * BH + cell] : __ldg(c0 + cell);  // cs: this thread's stores
    }
  };
  prefetch(T - 1);

  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;
    if (s > 0) {
      // dh~_{t+1} of the warp's rows, the partials of every block summed
      const u64* src = xbuf + (size_t)((s - 1) & 1) * slab;
      const unsigned want = tag0 + (unsigned)(s - 1);
      float dht = 0.0f;
      for (int i = 0; i < rows; ++i) {  // uniform across the warp
        const u64* at = src + (size_t)(warp + kWarps * i) * H + unit0 + u;
        float sum = 0.0f;
        for (int r0 = 0; lanes * r0 < blocks; r0 += kPartialsInFlight) {
          u64 v[kPartialsInFlight];
#pragma unroll
          for (int j = 0; j < kPartialsInFlight; ++j) {
            const int blk = sub + lanes * (r0 + j);
            v[j] = unit_ok && blk < blocks ? load_word(at + (size_t)blk * BH) : (u64)want << 32;
          }
          for (int spins = 0;; ++spins) {
            bool ready = true;
#pragma unroll
            for (int j = 0; j < kPartialsInFlight; ++j) ready &= (unsigned)(v[j] >> 32) == want;
            if (ready) break;
            if (spins > kMaxSpins) __trap();  // a lost word: fail, never hang
#pragma unroll
            for (int j = 0; j < kPartialsInFlight; ++j)
              if ((unsigned)(v[j] >> 32) != want)
                v[j] = load_word(at + (size_t)(sub + lanes * (r0 + j)) * BH);
          }
#pragma unroll
          for (int j = 0; j < kPartialsInFlight; ++j) sum += __uint_as_float((unsigned)v[j]);
        }
        for (int off = 16; off >= up; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (sub == i) dht = sum;
      }
      if (!kExchangeOnly && owner) {
        if (d_h_tilde) d_h_tilde[(size_t)(t + 1) * BH + cell] = dht;
        dh_carry = m_next * dht;
        dc_carry = m_next * dc_tilde;
      }
    }
    if (s == T) break;

    // step t of the lane's cell, its dg into shared memory
    const int par = s & 1;
    if (!kExchangeOnly && owner) {
      const float ig = sigmoid_fast(pg[0]), fg = sigmoid_fast(pg[1]);
      const float gg = tanh_fast(pg[2]), og = sigmoid_fast(pg[3]);
      const float tc = tanh_fast(c_t);
      const float dh = pgo + dh_carry;
      const float dc = dc_carry + dh * og * (1.0f - tc * tc);
      const float dg[4] = {dc * gg * ig * (1.0f - ig), dc * (pcp * pm) * fg * (1.0f - fg),
                           dc * ig * (1.0f - gg * gg), dh * tc * og * (1.0f - og)};
      float* out = d_gates + (size_t)t * B * G + gcell;
      float* mine = dg_s + (par * B + cell_b) * 4 * kMaxUnits + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        out[g * H] = dg[g];
        mine[g * kMaxUnits] = dg[g];
      }
      dc_tilde = dc * fg;
      if (d_c_tilde) d_c_tilde[(size_t)t * BH + cell] = dc_tilde;
      m_next = pm;
      c_t = pcp;
    }
    __syncthreads();

    // the block's partials of dh~_t for every row and unit; publish them
    u64* dst = xbuf + (size_t)par * slab + (size_t)blockIdx.x * BH;
    const u64 tag = (u64)(tag0 + (unsigned)s) << 32;
    for (int b = 0; b < B; ++b) {
      float acc[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) acc[i] = 0.0f;
      if (!kExchangeOnly) {
        const float4* d4 = reinterpret_cast<const float4*>(dg_s + (par * B + b) * 4 * kMaxUnits);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const float4 lo = d4[2 * gate], hi = d4[2 * gate + 1];
          const float d[kMaxUnits] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int uu = 0; uu < kMaxUnits; ++uu)
            if (uu < U) {
#pragma unroll
              for (int i = 0; i < KPT; ++i) acc[i] = fmaf(w[i][gate][uu], d[uu], acc[i]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int k = tid + kThreads * i;
        if (k < H) store_word(dst + (size_t)b * H + k, tag | __float_as_uint(acc[i]));
      }
    }
    if (t > 0) prefetch(t - 1);
  }
  if (!kExchangeOnly && owner) {
    d_h0[cell] = dh_carry;
    d_c0[cell] = dc_carry;
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

// ------------------------------------------------------------ wide H
//
// The kernels above keep W_hh's rows of a block's units in registers, KC
// <= 8 chunks of 16 bytes a lane (H <= 1024), and give each warp at most
// one unit (U <= 8).  Past either (H above 1024, or more than 8 units a
// block: H = 2048 on 132 SMs needs 16, and 512 on a card of 60 SMs 9), the
// wide kernels below run the same recurrence over the same grid of
// ceil(H / U) co-resident blocks, one an SM, with the exchanges, tags and
// epoch of the kernels above; the backward's grid is the forward's.
//
// What bounds them.  At H = 2048 W_hh is 64 MiB, a block's slice (its 4U
// rows of W_hh^T) 512 KiB, and the register files and shared memory of
// all 132 SMs hold about 62 MiB, part of which is needed for other things.
// So part of each slice is read again every step, and a step pays the
// exchange (on an H100 at H = 2048 about 2 µs for h, 4.7 for the
// backward's partials), its 2·B·H·4H float32 multiply-adds (2 µs at 67
// TFLOP/s) and the shared memory they read (the forward's warps each read
// all of h), and the copies of the streamed part.
//
// What the design does.  Both kernels split a block's slice the same way,
// into items of 2 KiB a warp: one unit's four gate rows by one 512-byte
// segment of each (32 chunks of 16 bytes, one a lane).  A warp's items go,
// in a fixed order, to registers (128 KiB a block at B <= 4, the
// accumulators sized by the launch's rows: 4, or kWideRows past 4), then
// to shared memory (copied at the start, one tensor copy an item), then to
// a ring of kWideRing slots of the warp's own in shared memory.  Lane 0 of
// the warp streams the ring's items, one tensor copy (TMA,
// cp.async.bulk.tensor) an item, completed on the slot's mbarrier,
// kWideRing - 1 items ahead of the warp's use, across the end of a step:
// W_hh does not depend on the step, so the next step's first items arrive
// while the block waits on the exchange.  No warp waits on another for
// W_hh.  (On an H100 at H = 2048 four bulk copies of 512 bytes an item
// took 2.7 µs more a step than one tensor copy, and a ring of 4 slots 1.4
// µs more than one of 2, whose room holds an item more on chip.)  A launch takes at most
// kWideRows batch rows (a larger batch runs as launches over slices).

constexpr int kWideRows = 8;     // batch rows one launch of a wide kernel takes
constexpr int kWideRing = 2;     // slots of a warp's ring of streamed items
static_assert((kWideRing & (kWideRing - 1)) == 0, "a ring's slots: a power of 2");
constexpr int kItemBytes = 4 * 32 * (int)sizeof(float4);  // 4 rows x 32 chunks of 16 bytes
constexpr int kWideInFlight = 32;  // h words a thread of the wide forward loads before it waits
constexpr size_t kWideRingBytes = (size_t)kWarps * kWideRing * kItemBytes;
// the rings' mbarriers and one a warp for its items' copies into shared memory at the start
constexpr size_t kWideBarBytes = (size_t)kWarps * (kWideRing + 1) * sizeof(u64);
// cluster sizes the wide backward takes, the first whose clusters all fit
// co-resident on the card; 1 (no cluster) otherwise
constexpr int kWideClusters[] = {4, 2};

// the accumulators' rows: the launch's batch rounded up to 4 or kWideRows
__host__ __device__ constexpr int wide_rows(int B) { return B <= 4 ? 4 : kWideRows; }
// forward: chunk indices j of a warp's first pair of units in registers
// (2 items each); backward: the units of chunk 0 in registers (1 item each)
__host__ __device__ constexpr int fwd_reg_chunks(int R) { return R == 4 ? 4 : 1; }
__host__ __device__ constexpr int bwd_reg_units(int R) { return R == 4 ? 8 : 6; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one item's tensor copy into shared memory (lane 0): the four gate rows of
// `unit` at k = k0 .. k0 + 127 through `w_map` (W_hh^T as (4 gates, H units,
// H) floats, boxes of (4, 1, 128); entries past H read as zeros), 2 KiB
// completed on `bar`, whose expected bytes the caller sets.  `streamed`: a
// ring's item, read again every step, kept in L2 before others
// (evict_last); else a copy made once a launch (evict_first)
__device__ __forceinline__ void copy_item(float4* dst, u64* bar, const CUtensorMap* w_map, int k0,
                                          int unit, bool streamed) {
  u64 policy;
  if (streamed)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4}], [%5], %6;" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(w_map)), "r"(k0), "r"(unit), "r"(0), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

// lane 0: expect `bytes` on `bar` and arrive (the copies complete the phase)
__device__ __forceinline__ void arrive_expect(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one item into a ring slot (lane 0), once the warp is done reading it
__device__ __forceinline__ void issue_item(float4* slot, u64* bar, const CUtensorMap* w_map,
                                           int k0, int unit) {
  // the warp's reads of the slot (generic proxy) before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  arrive_expect(bar, kItemBytes);
  copy_item(slot, bar, w_map, k0, unit, true);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// a float4 at the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ float4 cluster_load4(const float* p, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// acc[base + b] += the four products of w's values with row b's at chunk
// c of h, in turn (a function, not a lambda, so that it is inlined and the
// sums stay in registers)
template <int R>
__device__ __forceinline__ void fma_rows(float (&acc)[4 * R], int base, const float4 w,
                                         const float4 (&x)[R]) {
#pragma unroll
  for (int b = 0; b < R; ++b) {
    float& a = acc[base + b];
    a = fmaf(w.x, x[b].x, a);
    a = fmaf(w.y, x[b].y, a);
    a = fmaf(w.z, x[b].z, a);
    a = fmaf(w.w, x[b].w, a);
  }
}

// an item's four gate values of the lane (w[0], w[32], w[64], w[96]) into
// the sums of slot s of the pair (acc0 or acc1, each indexed by constants
// only, so that they stay in registers whether or not a loop over slots is
// unrolled)
template <int R>
__device__ __forceinline__ void fma_item(float (&acc0)[4 * R], float (&acc1)[4 * R], int s,
                                         const float4* w, const float4 (&x)[R]) {
  if (s == 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) fma_rows<R>(acc0, g * R, w[32 * g], x);
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) fma_rows<R>(acc1, g * R, w[32 * g], x);
  }
}

// one level of a reduce-scatter xor tree over the lanes: lane l keeps the
// half of a[i], a[i + n] (i < n) that bit `off` of l picks, summed with the
// other lane's (n a constant, so that a stays in registers)
template <int n, int M>
__device__ __forceinline__ void fold_lanes(float (&a)[M], int lane, int off) {
  const bool upper = lane & off;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float lo = a[i], hi = a[i + n];
    a[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, off);
  }
}

// rows b < B of h at chunk c from a (B, H) buffer, zero past B
template <int R>
__device__ __forceinline__ void load_rows(const float* h_s, int B, int H, int c,
                                          float4 (&x)[R]) {
#pragma unroll
  for (int b = 0; b < R; ++b)
    x[b] = b < B ? reinterpret_cast<const float4*>(h_s + (size_t)b * H)[c]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
}

// the products of a pair's chunks c0 + 32r (r < n) held in registers, wr[r]
// of both slots, with h's rows
template <int R, int RJ>
__device__ __forceinline__ void fma_registers(float (&acc0)[4 * R], float (&acc1)[4 * R],
                                              const float4 (&wr)[RJ][2][4], const float* h_s,
                                              int B, int H, int c0, int n, int chunks,
                                              bool live0, bool live1) {
#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    const int c = c0 + 32 * r;
    if (r < n && c < chunks) {
      float4 x[R];
      load_rows<R>(h_s, B, H, c, x);
      if (live0)
#pragma unroll
        for (int g = 0; g < 4; ++g) fma_rows<R>(acc0, g * R, wr[r][0][g], x);
      if (live1)
#pragma unroll
        for (int g = 0; g < 4; ++g) fma_rows<R>(acc1, g * R, wr[r][1][g], x);
    }
  }
}

// The wide forward.  Warp w takes the units w + 8s of its block (slots s),
// in pairs of slots p (units w + 16p and w + 16p + 8), one pair after
// another, and all batch rows of each: lane l sums, for the pair's 8 gate
// rows and R rows of h, its chunks c = l + 32j in increasing j, the four
// values of a chunk in turn (h read from shared memory once for both
// units); a reduce-scatter xor tree over the lanes (the additions of a full
// tree) leaves each lane the sum of 1 (R = 4) or 2 (R = 8) of the 8R, and
// the lanes that own the pair's 2B cells take their four gates from the
// warp's scratch in shared memory.  Items in order (pair, j, slot): pair
// 0's first fwd_reg_chunks(R) chunk indices j in registers, the next smem_pc
// (pair, j) in shared memory, the rest through the ring (the odd warps of a
// block of one pair a warp place them the other way round; the order of
// summation is j's either way).  h_{t-1} comes into one buffer of B rows in
// shared memory, between two block barriers (each thread's first words
// awaited before the first).  The owner reads
// gates_x, the mask and c_{t-1} (kept in cT, which only it writes) at the
// pair's start, so the loads are in flight during the product.
// kExchangeOnly: the grid running nothing but the h exchange (h = 0).
template <int R, bool kExchangeOnly>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_wide_kernel(const float* __restrict__ gates_x,  // (T, B, 4H)
                     const float* __restrict__ masks,    // (T, B)
                     const float* __restrict__ h0,       // (B, H)
                     const float* __restrict__ c0,       // (B, H)
                     const float* __restrict__ w_hh_t,   // (4H, H): row = gate*H + unit
                     const __grid_constant__ CUtensorMap w_map,  // w_hh_t's tiles (issue_item)
                     float* __restrict__ outs,           // (T, B, H)
                     float* __restrict__ hT,             // (B, H)
                     float* cT,                          // (B, H): c of the last step so far
                     u64* ws, int T, int B, int H, int U, int smem_pc) {
  constexpr int RJ = fwd_reg_chunks(R);
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * U;
  const int BH = B * H, chunks = H / 4, KC = (chunks + 31) / 32;
  const int slots = (U + kWarps - 1) / kWarps, P = (slots + 1) / 2;
  const int reg_pc = KC < RJ ? KC : RJ;  // (pair 0, j) in registers
  const int npc = P * KC, first = reg_pc + smem_pc;  // pair-chunks; past the ones on chip
  const bool ringed = first < npc;
  // where a warp's pair-chunks lie, as positions pc = p·KC + j: registers,
  // shared memory, then the ring; the odd warps of a block of one pair a
  // warp the other way round, ring first and registers last (the order of
  // summation stays j's), so that their waits on the ring overlap the even
  // warps' products rather than coming at the same time
  const bool flip = (warp & 1) && P == 1;
  const int reg_lo = flip ? npc - reg_pc : 0, smem_lo = flip ? npc - first : reg_pc;
  const int ring_lo = flip ? 0 : first, ring_hi = ring_lo + npc - first;
  // shared memory: the rings (warps, kWideRing, 4 rows, 32 lanes), the items
  // (warps, smem_pc, 2 slots, 4 rows, 32 lanes), h_{t-1} (B, H), the sums
  // (warps, 8R), the rings' mbarriers (warps, kWideRing)
  float4* ring = smem4 + (size_t)warp * kWideRing * 4 * 32;
  float4* w_s = smem4 + (ringed ? kWideRingBytes / sizeof(float4) : 0) +
                (size_t)warp * smem_pc * 2 * 4 * 32;
  float* h_s = reinterpret_cast<float*>(smem4 + (ringed ? kWideRingBytes / sizeof(float4) : 0) +
                                        (size_t)kWarps * smem_pc * 2 * 4 * 32);
  float* sums = h_s + (size_t)BH + warp * 8 * R;
  // the warp's ring slots' mbarriers, then its items' one
  u64* full = reinterpret_cast<u64*>(h_s + (size_t)BH + kWarps * 8 * R) + warp * (kWideRing + 1);
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;
  auto unit_of = [&](int s) { return warp + kWarps * s; };  // the block's unit of slot s
  auto live = [&](int s) { return s < slots && unit_of(s) < U && unit0 + unit_of(s) < H; };
  auto row = [&](int s, int gate) {  // W_hh^T's row of the gate of slot s's unit
    return w_hh_t + (size_t)(gate * H + unit0 + unit_of(s)) * H;
  };

  // the ring: lane 0 keeps the next item to issue (pair, j, slot of the
  // pair), stepped without divisions (its cost is the warp's), and the
  // count issued; the sequence repeats each step
  int streamed = 0;  // items through the ring a step
  for (int pc = ring_lo; pc < ring_hi; ++pc)
    streamed += live(2 * (pc / KC)) + live(2 * (pc / KC) + 1);
  const int total = kExchangeOnly ? 0 : streamed * T;
  int cur_pc = ring_lo, cur_p = ring_lo / KC, cur_j = ring_lo % KC, cur_s = -1, issued = 0;
  auto advance = [&] {
    do {
      if (++cur_s == 2) {
        cur_s = 0;
        if (++cur_pc == ring_hi) {
          cur_pc = ring_lo;
          cur_p = ring_lo / KC;
          cur_j = ring_lo % KC;
        } else if (++cur_j == KC) {
          cur_j = 0;
          ++cur_p;
        }
      }
    } while (!live(2 * cur_p + cur_s));
  };
  auto issue = [&] {
    const int slot = issued & (kWideRing - 1);
    issue_item(ring + slot * 4 * 32, full + slot, &w_map, 128 * cur_j,
               unit0 + unit_of(2 * cur_p + cur_s));
    ++issued;
    advance();
  };
  if (lane == 0) {
    for (int r = 0; r <= kWideRing; ++r) mbar_init(full + r, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (total > 0) {
      advance();
      while (issued < kWideRing && issued < total) issue();
    }
  }
  __syncwarp();

  // pair 0's chunks lane + 32(reg_lo + r), r < RJ, both slots, four gates
  // (read once a launch, evict-first, as are the items copied into shared
  // memory, so as not to push the ring's items out of L2)
  float4 wr[RJ][2][4];
#pragma unroll
  for (int r = 0; r < RJ; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int c = lane + 32 * (reg_lo + r);
        wr[r][s][g] = !kExchangeOnly && r < reg_pc && c < chunks && live(s)
                          ? __ldcs(reinterpret_cast<const float4*>(row(s, g)) + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  // the items in shared memory, one tensor copy each, all in flight at
  // once (a dead slot's item is never read)
  if (lane == 0 && !kExchangeOnly && smem_pc > 0) {
    int live_items = 0;
    for (int q = 0; q < smem_pc; ++q)
      live_items += live(2 * ((smem_lo + q) / KC)) + live(2 * ((smem_lo + q) / KC) + 1);
    arrive_expect(full + kWideRing, (unsigned)live_items * kItemBytes);
    for (int q = 0; q < smem_pc; ++q) {
      const int pc = smem_lo + q, p = pc / KC, j = pc % KC;
      for (int s = 0; s < 2; ++s)
        if (live(2 * p + s))
          copy_item(w_s + (q * 2 + s) * 4 * 32, full + kWideRing, &w_map, 128 * j,
                    unit0 + unit_of(2 * p + s), false);
    }
  }
  if (!kExchangeOnly) {
#pragma unroll 8
    for (int i = tid; i < BH; i += kThreads) h_s[i] = __ldg(h0 + i);
  }
  if (!kExchangeOnly && smem_pc > 0) mbar_wait(full + kWideRing, 0);
  __syncthreads();

  int used = 0;  // items of the ring's sequence the warp has used
  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      // h of step t-1 from every block, as in lstm_seq_kernel, into the
      // buffer that every warp is done reading: each thread's first
      // kWideInFlight words are awaited before the block barrier, so that
      // the wait overlaps the warps still on step t-1
      const u64* src = xbuf + (size_t)((t - 1) & 1) * BH;
      const unsigned want = tag0 + (unsigned)(t - 1);
      for (int base = tid, round = 0; round == 0 || base < BH;
           base += kThreads * kWideInFlight, ++round) {
        u64 v[kWideInFlight];
#pragma unroll
        for (int j = 0; j < kWideInFlight; ++j) {
          const int i = base + j * kThreads;
          v[j] = i < BH ? load_word(src + i) : (u64)want << 32;
        }
        for (int spins = 0;; ++spins) {
          bool ready = true;
#pragma unroll
          for (int j = 0; j < kWideInFlight; ++j) ready &= (unsigned)(v[j] >> 32) == want;
          if (ready) break;
          if (spins > kMaxSpins) __trap();  // a lost word: fail, never hang
#pragma unroll
          for (int j = 0; j < kWideInFlight; ++j)
            if ((unsigned)(v[j] >> 32) != want) v[j] = load_word(src + base + j * kThreads);
        }
        if (round == 0) __syncthreads();  // every thread takes round 0
        if (!kExchangeOnly) {
#pragma unroll
          for (int j = 0; j < kWideInFlight; ++j) {
            const int i = base + j * kThreads;
            if (i < BH) h_s[i] = __uint_as_float((unsigned)v[j]);
          }
        }
      }
      __syncthreads();
    }

    for (int p = 0; p < P; ++p) {
      if (!live(2 * p) && !live(2 * p + 1)) continue;  // uniform across the warp
      // lane s·R + b owns the cell (row b, the unit of slot 2p + s)
      const int os = lane / R, ob = lane % R;
      const bool owner = lane < 2 * R && ob < B && live(2 * p + os);
      const size_t cell = (size_t)ob * H + unit0 + unit_of(2 * p + os);
      if (kExchangeOnly) {
        if (owner && t < T - 1)
          store_word(xbuf + (size_t)(t & 1) * BH + cell, (u64)(tag0 + (unsigned)t) << 32);
        continue;
      }
      float gx[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.0f, cp = 0.0f;
      if (owner) {
        const float* q = gates_x + ((size_t)t * B + ob) * 4 * H + unit0 + unit_of(2 * p + os);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) gx[gate] = __ldg(q + gate * H);
        m = __ldg(masks + (size_t)t * B + ob);
        cp = t == 0 ? __ldg(c0 + cell) : cT[cell];  // cT: this thread's own store
      }
      // the sums of slot 0 and slot 1 of the pair, value gate·R + b for row b
      constexpr int N = 8 * R;
      float acc0[N / 2], acc1[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc0[i] = acc1[i] = 0.0f;
      // pair 0's chunks in registers, j = reg_lo + r (first, or last where flip)
      if (p == 0 && !flip)
        fma_registers<R, RJ>(acc0, acc1, wr, h_s, B, H, lane + 32 * reg_lo, reg_pc, chunks,
                             live(0), live(1));
      for (int j = p == 0 && !flip ? reg_pc : 0; j < (p == 0 && flip ? KC - reg_pc : KC); ++j) {
        const int c = lane + 32 * j, q = p * KC + j - smem_lo;
        const bool valid = c < chunks;
        float4 x[R];
        if (valid) load_rows<R>(h_s, B, H, c, x);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (!live(2 * p + s)) continue;  // uniform
          if (q >= 0 && q < smem_pc) {
            if (valid) fma_item<R>(acc0, acc1, s, w_s + (q * 2 + s) * 4 * 32 + lane, x);
          } else {
            const int slot = used & (kWideRing - 1);
            mbar_wait(full + slot, (unsigned)(used / kWideRing) & 1u);
            if (valid) fma_item<R>(acc0, acc1, s, ring + slot * 4 * 32 + lane, x);
            __syncwarp();
            ++used;
            if (lane == 0 && issued < total) issue();
          }
        }
      }
      if (p == 0 && flip)
        fma_registers<R, RJ>(acc0, acc1, wr, h_s, B, H, lane + 32 * reg_lo, reg_pc, chunks,
                             live(0), live(1));
      // the pair's 8R sums over the lanes, value v = s·4R + gate·R + b: v
      // ends in lane v / (N / 32), element v mod (N / 32) (selects of
      // values, so that the sums stay in registers)
      float acc[N / 2];
      {
        const bool upper = lane & 16;
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          acc[i] = (upper ? acc1[i] : acc0[i]) +
                   __shfl_xor_sync(0xffffffffu, upper ? acc0[i] : acc1[i], 16);
      }
      fold_lanes<N / 4>(acc, lane, 8);
      fold_lanes<N / 8>(acc, lane, 4);
      fold_lanes<N / 16>(acc, lane, 2);
      fold_lanes<N / 32>(acc, lane, 1);
#pragma unroll
      for (int e = 0; e < N / 32; ++e) sums[lane * (N / 32) + e] = acc[e];
      __syncwarp();
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (lane < 2 * R)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) g[gate] = sums[(os * 4 + gate) * R + ob];
      __syncwarp();
      if (owner) {
        const float gi = fmaf(m, g[0], gx[0]);
        const float gf = fmaf(m, g[1], gx[1]);
        const float gg = fmaf(m, g[2], gx[2]);
        const float go = fmaf(m, g[3], gx[3]);
        const float c = sigmoid_fast(gf) * (cp * m) + sigmoid_fast(gi) * tanh_fast(gg);
        const float h = sigmoid_fast(go) * tanh_fast(c);
        outs[(size_t)t * BH + cell] = h;
        cT[cell] = c;
        if (t == T - 1) hT[cell] = h;
        if (t < T - 1)
          store_word(xbuf + (size_t)(t & 1) * BH + cell,
                     ((u64)(tag0 + (unsigned)t) << 32) | __float_as_uint(h));
      }
    }
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

// The direct wide forward, kept for the shapes whose h does not fit in a
// block's shared memory beside the ring (B·H above about 49,000: H above
// 6,168 at 8 rows, 49,616 at one): each lane reads the words of h it
// multiplies from the exchange itself, waiting on their tags (every warp
// reads all of h_{t-1} before it publishes h_t, so the two buffers stay
// safe without a block barrier).  Warp w takes the units w, w + 8, ... of
// its block (slots s), one after another, and all batch pairs of each;
// lane b owns the cell (row b, the slot's unit).  For each chunk c = lane +
// 32j of the unit's four gate rows (from registers, shared memory or L2,
// the items in slot-major, then chunk order) the lane adds its products
// with every pair's h rows, chunk by chunk in increasing j, the four values
// of a chunk in turn; the xor tree of lstm_seq_kernel sums the lanes.
constexpr int kDirectPairs = kWideRows / kTaskBatch;
constexpr int kDirectRegChunks = 4;  // chunks of the lane's first unit in registers
constexpr size_t kDirectItemBytes = (size_t)kWarps * 4 * 32 * sizeof(float4);

// h of step t-1 for one chunk (4 units) of one row, straight from the
// exchange's tagged words, reloading until all four carry tag ``want``
__device__ __forceinline__ float4 h4_direct(const u64* src, unsigned want) {
  u64 v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = load_word(src + e);
  for (int spins = 0;; ++spins) {
    bool ready = true;
#pragma unroll
    for (int e = 0; e < 4; ++e) ready &= (unsigned)(v[e] >> 32) == want;
    if (ready) break;
    if (spins > kMaxSpins) __trap();  // a lost word: fail, never hang
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((unsigned)(v[e] >> 32) != want) v[e] = load_word(src + e);
  }
  return make_float4(__uint_as_float((unsigned)v[0]), __uint_as_float((unsigned)v[1]),
                     __uint_as_float((unsigned)v[2]), __uint_as_float((unsigned)v[3]));
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_wide_direct_kernel(const float* __restrict__ gates_x,  // (T, B, 4H)
                            const float* __restrict__ masks,    // (T, B)
                            const float* __restrict__ h0,       // (B, H)
                            const float* __restrict__ c0,       // (B, H)
                            const float* __restrict__ w_hh_t,   // (4H, H)
                            float* __restrict__ outs,           // (T, B, H)
                            float* __restrict__ hT,             // (B, H)
                            float* cT,                          // (B, H)
                            u64* ws, int T, int B, int H, int U, int smem_items) {
  extern __shared__ float4 smem4[];
  const int b_pad = (B + kTaskBatch - 1) / kTaskBatch * kTaskBatch;
  float4* w_s = smem4;  // (warps, items, 4 gates, 32 lanes)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * U;
  const int BH = B * H, chunks = H / 4, KC = (chunks + 31) / 32, pairs = b_pad / kTaskBatch;
  const int slots = (U + kWarps - 1) / kWarps;
  const int reg_chunks = KC < kDirectRegChunks ? KC : kDirectRegChunks;
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;
  auto unit_of = [&](int s) { return warp + kWarps * s; };  // the block's unit of slot s
  auto live = [&](int s) { return unit_of(s) < U && unit0 + unit_of(s) < H; };
  auto w_row = [&](int gate, int s) {
    return reinterpret_cast<const float4*>(w_hh_t + (size_t)(gate * H + unit0 + unit_of(s)) * H);
  };
  auto w_smem = [&](int item, int gate) {
    return w_s + (((size_t)warp * smem_items + item) * 4 + gate) * 32 + lane;
  };

  float4 wr[4][kDirectRegChunks];  // slot 0's chunks lane + 32j, j < kDirectRegChunks
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int j = 0; j < kDirectRegChunks; ++j) {
      const int c = lane + 32 * j;
      wr[gate][j] = live(0) && j < KC && c < chunks ? __ldg(w_row(gate, 0) + c)
                                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  // the next items, slot-major, into shared memory: item s·KC + j - reg_chunks
  for (int s = 0; s < slots; ++s)
    for (int j = s == 0 ? reg_chunks : 0; j < KC; ++j) {
      const int item = s * KC + j - reg_chunks, c = lane + 32 * j;
      if (item >= smem_items) break;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        *w_smem(item, gate) = live(s) && c < chunks ? __ldg(w_row(gate, s) + c)
                                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const u64* src = xbuf + (size_t)((t - 1) & 1) * BH;  // h_{t-1}'s words (t > 0)
    const unsigned want = tag0 + (unsigned)(t - 1);
    // rows r of h_{t-1} at chunk c: zero past B
    auto h4 = [&](int r, int c) {
      if (r >= B) return make_float4(0.f, 0.f, 0.f, 0.f);
      if (t == 0) return __ldg(reinterpret_cast<const float4*>(h0 + (size_t)r * H) + c);
      return h4_direct(src + (size_t)r * H + 4 * c, want);
    };

    for (int s = 0; s < slots && live(s); ++s) {  // uniform across the warp
      const int unit = unit0 + unit_of(s);
      const bool owner = lane < B;
      const size_t cell = (size_t)lane * H + unit;
      float gx[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.0f, cp = 0.0f;
      if (owner) {
        const float* p = gates_x + ((size_t)t * B + lane) * 4 * H + unit;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) gx[gate] = __ldg(p + gate * H);
        m = __ldg(masks + (size_t)t * B + lane);
        cp = t == 0 ? __ldg(c0 + cell) : cT[cell];  // cT: this thread's own store
      }
      float acc[kDirectPairs][4 * kTaskBatch];  // acc[pair][gate * 2 + i]
#pragma unroll
      for (int p = 0; p < kDirectPairs; ++p)
#pragma unroll
        for (int j = 0; j < 4 * kTaskBatch; ++j) acc[p][j] = 0.0f;
      auto chunk = [&](int c, const float4 (&wv)[4]) {
#pragma unroll
        for (int p = 0; p < kDirectPairs; ++p) {
          if (p < pairs) {
            const float4 x0 = h4(2 * p, c), x1 = h4(2 * p + 1, c);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
              float& a0 = acc[p][2 * gate];
              float& a1 = acc[p][2 * gate + 1];
              a0 = fmaf(wv[gate].x, x0.x, a0);
              a0 = fmaf(wv[gate].y, x0.y, a0);
              a0 = fmaf(wv[gate].z, x0.z, a0);
              a0 = fmaf(wv[gate].w, x0.w, a0);
              a1 = fmaf(wv[gate].x, x1.x, a1);
              a1 = fmaf(wv[gate].y, x1.y, a1);
              a1 = fmaf(wv[gate].z, x1.z, a1);
              a1 = fmaf(wv[gate].w, x1.w, a1);
            }
          }
        }
      };
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < kDirectRegChunks; ++j) {
          const int c = lane + 32 * j;
          if (j < KC && c < chunks) {
            const float4 wv[4] = {wr[0][j], wr[1][j], wr[2][j], wr[3][j]};
            chunk(c, wv);
          }
        }
      }
      int j = s == 0 ? reg_chunks : 0;
      for (; j < KC && s * KC + j - reg_chunks < smem_items; ++j) {
        const int c = lane + 32 * j, item = s * KC + j - reg_chunks;
        if (c >= chunks) continue;
        const float4 wv[4] = {*w_smem(item, 0), *w_smem(item, 1), *w_smem(item, 2),
                              *w_smem(item, 3)};
        chunk(c, wv);
      }
      // the rest from L2, one chunk at a time (the spinning reads of h need
      // the registers)
      for (; j < KC; ++j) {
        const int c = lane + 32 * j;
        if (c >= chunks) continue;
        const float4 wv[4] = {__ldg(w_row(0, s) + c), __ldg(w_row(1, s) + c),
                              __ldg(w_row(2, s) + c), __ldg(w_row(3, s) + c)};
        chunk(c, wv);
      }
      // each pair's sums over the lanes (the xor tree of lstm_seq_kernel);
      // lane 2p + i keeps the four gate sums of its cell in g
      float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < kDirectPairs; ++p) {
        if (p >= pairs) break;  // uniform
        float* a = acc[p];
#pragma unroll
        for (int n = 4, off = 16; n > 0; n >>= 1, off >>= 1) {
          const bool upper = lane & off;
#pragma unroll
          for (int j = 0; j < n; ++j) {
            const float send = upper ? a[j] : a[j + n];
            a[j] = (upper ? a[j + n] : a[j]) + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        a[0] += __shfl_xor_sync(0xffffffffu, a[0], 2);
        a[0] += __shfl_xor_sync(0xffffffffu, a[0], 1);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const float v = __shfl_sync(0xffffffffu, a[0], 4 * (2 * gate + (lane & 1)));
          if ((lane >> 1) == p) g[gate] = v;
        }
      }
      if (owner) {
        const float gi = fmaf(m, g[0], gx[0]);
        const float gf = fmaf(m, g[1], gx[1]);
        const float gg = fmaf(m, g[2], gx[2]);
        const float go = fmaf(m, g[3], gx[3]);
        const float c = sigmoid_fast(gf) * (cp * m) + sigmoid_fast(gi) * tanh_fast(gg);
        const float h = sigmoid_fast(go) * tanh_fast(c);
        outs[(size_t)t * BH + cell] = h;
        cT[cell] = c;
        if (t == T - 1) hT[cell] = h;
        if (t < T - 1)
          store_word(xbuf + (size_t)(t & 1) * BH + cell,
                     ((u64)(tag0 + (unsigned)t) << 32) | __float_as_uint(h));
      }
    }
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

// The partials backward past H = 1024 or 8 units a block: the VJP, the
// outputs, the c_t sweep, the tags and the epoch of
// lstm_seq_backward_partials_kernel, over any U, on the forward's grid.  A
// cell (row b, unit u) of the block is handled by a group of G lanes (G a
// power of 2, up to 32, as many as 256 threads give every cell of the block
// at once, in rounds past that): the group gathers dh~_{t+1} of the cell,
// the partial sums of every published set (a cluster's, or a block's
// without clusters) split among its lanes (lane sub takes sets sub, sub +
// G, ... in turn) and summed by an xor tree, and its first lane (the owner)
// runs the cell's step.  The owner keeps nothing in registers across steps:
// it reads the step's inputs and the mask of the step after at use, and
// keeps dc~ of the step after in d_c0 (its own words; d_c0 gets its value
// at the end).  Then thread tid forms, for its chunks c = tid + 256i of
// W_hh's rows (4 entries k = 4c + e) and every row b, the block's partial
// sum over its 4U columns of W_hh, unit by unit, the four gates in turn
// (items (i, u): chunk 0 of the first bwd_reg_units(R) units in registers,
// then smem_items in shared memory, then the ring).  In a cluster of C
// blocks each block puts its partials in its shared memory; after a cluster
// barrier block rank r sums the C blocks' partials of its C-th of the
// chunks, rank by rank, through distributed shared memory, and publishes
// them as the cluster's set: (grid / C)·B·H words a step over the grid,
// not grid·B·H.  A second barrier phase, waited on before the next step's
// partials, keeps them until every rank has read them.
template <int R, bool kExchangeOnly>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_backward_partials_wide_kernel(const float* __restrict__ gates,   // (T, B, 4H)
                                       const float* __restrict__ masks,   // (T, B)
                                       const float* __restrict__ c0,      // (B, H)
                                       const float* __restrict__ w_hh_t,  // (4H, H)
                                       const __grid_constant__ CUtensorMap w_map,  // its tiles
                                       const float* __restrict__ g_outs,  // (T, B, H)
                                       const float* __restrict__ g_hT,    // (B, H)
                                       const float* __restrict__ g_cT,    // (B, H)
                                       float* __restrict__ d_gates,       // (T, B, 4H)
                                       float* __restrict__ d_h0,          // (B, H)
                                       float* d_c0,                       // (B, H): dc~ so far
                                       float* cs,                         // (T, B, H): c_t
                                       float* __restrict__ d_h_tilde,     // (T, B, H) or null
                                       float* __restrict__ d_c_tilde,     // (T, B, H) or null
                                       u64* ws, int T, int B, int H, int U, int smem_items) {
  constexpr int RU = bwd_reg_units(R);
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = (int)cluster_blocks(), rank = (int)cluster_rank();
  const int sets = gridDim.x / C, unit0 = blockIdx.x * U;
  const int BH = B * H, G4 = 4 * H, chunks = H / 4, KI = (chunks + kThreads - 1) / kThreads;
  const size_t slab = (size_t)sets * BH;  // one buffer of partials: (sets, B, H)
  const int reg_u = U < RU ? U : RU;       // (chunk 0, u) in registers
  const int nf = KI * U, first = reg_u + smem_items;  // items, as i·U + u; the first streamed
  const bool ringed = first < nf;
  // shared memory: the rings (warps, kWideRing, 4 gates, 32 lanes), the
  // items (warps, smem_items, 4 gates, 32 lanes), the block's partials (B,
  // H) when C > 1, its cells' dg by stage parity 2 x (U, 4 gates, R), zero
  // past B, and the rings' mbarriers
  float4* ring = smem4 + (size_t)warp * kWideRing * 4 * 32;
  float4* w_s = smem4 + (ringed ? kWideRingBytes / sizeof(float4) : 0) +
                (size_t)warp * smem_items * 4 * 32;
  float* red_s = reinterpret_cast<float*>(smem4 + (ringed ? kWideRingBytes / sizeof(float4) : 0) +
                                          (size_t)kWarps * smem_items * 4 * 32);
  float* dg_s = red_s + (C > 1 ? (size_t)BH : 0);
  u64* full = reinterpret_cast<u64*>(dg_s + 2 * (size_t)U * 4 * R) + warp * (kWideRing + 1);
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;
  const int cells = B * U;
  int lanes = 32;  // G: lanes a cell
  while (lanes > 1 && cells * lanes > kThreads) lanes >>= 1;
  const int per_round = kThreads / lanes, sub = lane & (lanes - 1);
  // item (i, u) of the warp: live unless its unit lies past H or its
  // segment (chunks 256i + 32·warp ..) past the last chunk
  auto live = [&](int i, int u) {
    return unit0 + u < H && kThreads * i + 32 * warp < chunks;
  };
  auto row = [&](int gate, int u) { return w_hh_t + (size_t)(gate * H + unit0 + u) * H; };

  int streamed = 0;  // items through the ring a stage
  for (int f = first; f < nf; ++f) streamed += live(f / U, f % U);
  const int total = kExchangeOnly ? 0 : streamed * T;
  // lane 0's next item to issue, (i, u), stepped without divisions
  const int i_first = first / U, u_first = first % U;
  int cur_i = i_first, cur_u = u_first - 1, issued = 0;
  auto advance = [&] {
    do {
      if (++cur_u == U) {
        cur_u = 0;
        if (++cur_i == KI) {
          cur_i = i_first;
          cur_u = u_first;
        }
      }
    } while (!live(cur_i, cur_u));
  };
  auto issue = [&] {
    const int slot = issued & (kWideRing - 1);
    issue_item(ring + slot * 4 * 32, full + slot, &w_map, 4 * (kThreads * cur_i + 32 * warp),
               unit0 + cur_u);
    ++issued;
    advance();
  };
  if (lane == 0) {
    for (int r = 0; r <= kWideRing; ++r) mbar_init(full + r, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (total > 0) {
      advance();
      while (issued < kWideRing && issued < total) issue();
    }
  }
  __syncwarp();

  float4 wr[RU][4];  // W_hh^T[gate·H + unit0 + u, 4·tid ..], u < RU (read once, evict-first)
#pragma unroll
  for (int u = 0; u < RU; ++u)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      wr[u][g] = !kExchangeOnly && u < U && unit0 + u < H && tid < chunks
                     ? __ldcs(reinterpret_cast<const float4*>(row(g, u)) + tid)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  // the items in shared memory, one tensor copy each, all in flight at
  // once (a dead item is never read)
  if (lane == 0 && !kExchangeOnly && smem_items > 0) {
    int live_items = 0;
    for (int q = 0; q < smem_items; ++q) live_items += live((reg_u + q) / U, (reg_u + q) % U);
    arrive_expect(full + kWideRing, (unsigned)live_items * kItemBytes);
    for (int q = 0; q < smem_items; ++q) {
      const int i = (reg_u + q) / U, u = (reg_u + q) % U;
      if (live(i, u))
        copy_item(w_s + q * 4 * 32, full + kWideRing, &w_map, 4 * (kThreads * i + 32 * warp),
                  unit0 + u, false);
    }
  }
  for (int i = tid; i < 2 * U * 4 * R; i += kThreads) dg_s[i] = 0.0f;

  // c_t of each cell the thread owns, t = 0 .. T-1, into cs
  for (int base = 0; base < cells; base += per_round) {
    const int ci = base + tid / lanes, b = ci / U, unit = unit0 + ci % U;
    if (kExchangeOnly || sub != 0 || ci >= cells || unit >= H) continue;
    const size_t cell = (size_t)b * H + unit;
    float c = __ldg(c0 + cell);
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const float* p = gates + ((size_t)t * B + b) * G4 + unit;
      const float m = __ldg(masks + (size_t)t * B + b);
      c = sigmoid_fast(__ldg(p + H)) * (c * m) +
          sigmoid_fast(__ldg(p)) * tanh_fast(__ldg(p + 2 * H));
      cs[(size_t)t * BH + cell] = c;
    }
  }
  if (!kExchangeOnly && smem_items > 0) mbar_wait(full + kWideRing, 0);
  __syncthreads();

  int used = 0;  // items of the ring's sequence the warp has used
  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s, par = s & 1;
    const u64* src = xbuf + (size_t)((s - 1) & 1) * slab;
    const unsigned want = tag0 + (unsigned)(s - 1);
    for (int base = 0; base < cells; base += per_round) {  // uniform
      const int ci = base + tid / lanes, b = ci / U, u = ci % U, unit = unit0 + u;
      const bool valid = ci < cells && unit < H;
      float dht = 0.0f;
      if (s > 0) {
        // dh~_{t+1} of the cell: the partials of every set, split among
        // the group's lanes, kPartialsInFlight at a time
        const u64* at = src + (size_t)b * H + unit;
        for (int r0 = 0; lanes * r0 < sets; r0 += kPartialsInFlight) {
          u64 v[kPartialsInFlight];
#pragma unroll
          for (int j = 0; j < kPartialsInFlight; ++j) {
            const int set = sub + lanes * (r0 + j);
            v[j] = valid && set < sets ? load_word(at + (size_t)set * BH) : (u64)want << 32;
          }
          for (int spins = 0;; ++spins) {
            bool ready = true;
#pragma unroll
            for (int j = 0; j < kPartialsInFlight; ++j) ready &= (unsigned)(v[j] >> 32) == want;
            if (ready) break;
            if (spins > kMaxSpins) __trap();  // a lost word: fail, never hang
#pragma unroll
            for (int j = 0; j < kPartialsInFlight; ++j)
              if ((unsigned)(v[j] >> 32) != want)
                v[j] = load_word(at + (size_t)(sub + lanes * (r0 + j)) * BH);
          }
#pragma unroll
          for (int j = 0; j < kPartialsInFlight; ++j) dht += __uint_as_float((unsigned)v[j]);
        }
        for (int off = lanes >> 1; off > 0; off >>= 1)
          dht += __shfl_xor_sync(0xffffffffu, dht, off);
      }
      if (kExchangeOnly || sub != 0 || !valid) continue;
      const size_t cell = (size_t)b * H + unit;
      float dh_carry, dc_carry;
      if (s == 0) {
        dh_carry = __ldg(g_hT + cell);
        dc_carry = __ldg(g_cT + cell);
      } else {
        const float m_next = __ldg(masks + (size_t)(t + 1) * B + b);
        if (d_h_tilde) d_h_tilde[(size_t)(t + 1) * BH + cell] = dht;
        dh_carry = m_next * dht;
        dc_carry = m_next * d_c0[cell];  // dc~_{t+1}: this thread's own store
      }
      if (s == T) {
        d_h0[cell] = dh_carry;
        d_c0[cell] = dc_carry;
        continue;
      }
      const float* p = gates + ((size_t)t * B + b) * G4 + unit;
      const float pm = __ldg(masks + (size_t)t * B + b);
      const float pcp = t > 0 ? cs[(size_t)(t - 1) * BH + cell] : __ldg(c0 + cell);
      const float c_t = cs[(size_t)t * BH + cell];
      const float ig = sigmoid_fast(__ldg(p)), fg = sigmoid_fast(__ldg(p + H));
      const float gg = tanh_fast(__ldg(p + 2 * H)), og = sigmoid_fast(__ldg(p + 3 * H));
      const float tc = tanh_fast(c_t);
      const float dh = __ldg(g_outs + (size_t)t * BH + cell) + dh_carry;
      const float dc = dc_carry + dh * og * (1.0f - tc * tc);
      const float dg[4] = {dc * gg * ig * (1.0f - ig), dc * (pcp * pm) * fg * (1.0f - fg),
                           dc * ig * (1.0f - gg * gg), dh * tc * og * (1.0f - og)};
      float* out = d_gates + ((size_t)t * B + b) * G4 + unit;
      float* mine = dg_s + (((size_t)par * U + u) * 4) * R + b;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        out[gate * H] = dg[gate];
        mine[gate * R] = dg[gate];
      }
      d_c0[cell] = dc * fg;
      if (d_c_tilde) d_c_tilde[(size_t)t * BH + cell] = dc * fg;
    }
    if (s == T) break;
    __syncthreads();

    // the block's partials of dh~_t for every row and entry k
    const float* dgp = dg_s + (size_t)par * U * 4 * R;
    const u64 tag = (u64)(tag0 + (unsigned)s) << 32;
    if (C > 1 && s > 0) cluster_wait();  // every rank has read the last step's partials
    for (int i = 0; i < KI; ++i) {
      const int c = tid + kThreads * i;
      float acc[4][R];  // (entry k = 4c + e, row)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int b = 0; b < R; ++b) acc[e][b] = 0.0f;
      auto add = [&](int u, const float4 w, int gate) {
        float d[R];
#pragma unroll
        for (int b4 = 0; b4 < R / 4; ++b4) {
          const float4 d4 = reinterpret_cast<const float4*>(dgp + (u * 4 + gate) * R)[b4];
          d[4 * b4] = d4.x;
          d[4 * b4 + 1] = d4.y;
          d[4 * b4 + 2] = d4.z;
          d[4 * b4 + 3] = d4.w;
        }
#pragma unroll
        for (int b = 0; b < R; ++b) {
          acc[0][b] = fmaf(w.x, d[b], acc[0][b]);
          acc[1][b] = fmaf(w.y, d[b], acc[1][b]);
          acc[2][b] = fmaf(w.z, d[b], acc[2][b]);
          acc[3][b] = fmaf(w.w, d[b], acc[3][b]);
        }
      };
      if (!kExchangeOnly) {
        int u = 0;
        if (i == 0) {
#pragma unroll
          for (int uu = 0; uu < RU; ++uu)
            if (uu < U && unit0 + uu < H)
#pragma unroll
              for (int g = 0; g < 4; ++g) add(uu, wr[uu][g], g);
          u = reg_u;
        }
        for (; u < U; ++u) {
          if (!live(i, u)) continue;  // uniform across the warp
          const int q = i * U + u - reg_u;
          if (q < smem_items) {
#pragma unroll
            for (int g = 0; g < 4; ++g) add(u, w_s[q * 4 * 32 + g * 32 + lane], g);
          } else {
            const int slot = used & (kWideRing - 1);
            mbar_wait(full + slot, (unsigned)(used / kWideRing) & 1u);
#pragma unroll
            for (int g = 0; g < 4; ++g) add(u, ring[slot * 4 * 32 + g * 32 + lane], g);
            __syncwarp();
            ++used;
            if (lane == 0 && issued < total) issue();
          }
        }
      }
      if (c >= chunks) continue;
      // (rows unrolled, so that the sums stay in registers)
      if (C == 1) {  // publish the block's partials as its set
        u64* dst = xbuf + (size_t)par * slab + (size_t)blockIdx.x * BH + 4 * c;
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (b < B)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              store_word(dst + (size_t)b * H + e, tag | __float_as_uint(acc[e][b]));
      } else {
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (b < B)
            reinterpret_cast<float4*>(red_s + (size_t)b * H)[c] =
                make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
      }
    }
    if (C > 1) {
      // the cluster's sums of this rank's chunks, rank by rank; publish them
      cluster_arrive();
      cluster_wait();
      const int per = (chunks + C - 1) / C, lo = rank * per;
      const int n = chunks - lo < per ? chunks - lo : per;
      u64* dst = xbuf + (size_t)par * slab + (size_t)(blockIdx.x / C) * BH;
      for (int idx = tid; idx < B * n; idx += kThreads) {
        const int b = idx / n, c = lo + idx % n;
        const float* at = red_s + (size_t)b * H + 4 * c;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < C; ++r) {
          const float4 v = cluster_load4(at, (unsigned)r);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        u64* w = dst + (size_t)b * H + 4 * c;
        store_word(w, tag | __float_as_uint(sum.x));
        store_word(w + 1, tag | __float_as_uint(sum.y));
        store_word(w + 2, tag | __float_as_uint(sum.z));
        store_word(w + 3, tag | __float_as_uint(sum.w));
      }
      cluster_arrive();  // this rank is done reading: waited on before the next partials
    }
  }
  if (C > 1) cluster_wait();  // no block leaves while a rank may read its partials

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

// the backward's two buffers of dg: B rounded up to kTaskBatch rows of 4H
size_t backward_smem_bytes(int B, int H) {
  const size_t b_pad = (size_t)(B + kTaskBatch - 1) / kTaskBatch * kTaskBatch;
  return 2 * b_pad * 4 * H * sizeof(float);
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

// One cooperative launch of ceil(H / U) blocks of `kernel`, rounded up to
// clusters of C blocks (cudaLaunchKernelEx with the cooperative and, for C
// > 1, the cluster attribute), whose per-device capacity is kept in
// `capacity`.
int cooperative_launch(const void* kernel, Capacity* capacity, int dev, int H, int U,
                       size_t smem, void** args, void* stream, int C = 1) {
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
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
  const int grid = ((H + U - 1) / U + C - 1) / C * C;
  if (cap.blocks < grid) return kNotCoResident;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = C;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KC, bool kExchangeOnly>
int launch(const void* gates_x, const void* masks, const void* h0, const void* c0,
           const void* w_hh_t, void* outs, void* hT, void* cT, void* ws, int T,
           int B, int H, int U, int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  void* args[] = {&gates_x, &masks, &h0, &c0, &w_hh_t, &outs, &hT, &cT, &ws,
                  &T,       &B,     &H,  &U};
  // the exchange-only grid takes the same shared memory, so it lands on the
  // same SMs, one block each
  return cooperative_launch((const void*)lstm_seq_kernel<KC, kExchangeOnly>, capacity, dev,
                            H, U, smem_bytes(B, H), args, stream);
}

template <int KC, bool kExchangeOnly>
int launch_backward(const void* gates, const void* masks, const void* c0, const void* w_hh,
                    const void* g_outs, const void* g_hT, const void* g_cT, void* d_gates,
                    void* d_h0, void* d_c0, void* cs, void* d_h_tilde, void* d_c_tilde,
                    void* ws, int T, int B, int H, int U, int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  void* args[] = {&gates, &masks, &c0,   &w_hh,      &g_outs,    &g_hT, &g_cT,
                  &d_gates, &d_h0, &d_c0, &cs, &d_h_tilde, &d_c_tilde, &ws,
                  &T,     &B,     &H,    &U};
  return cooperative_launch((const void*)lstm_seq_backward_kernel<KC, kExchangeOnly>, capacity,
                            dev, H, U, backward_smem_bytes(B, H), args, stream);
}

// the partials kernel's shared memory: its cells' dg, two buffers of
// (B, 4 gates, kMaxUnits) floats
size_t partials_smem_bytes(int B) { return 2 * (size_t)B * 4 * kMaxUnits * sizeof(float); }

// rows one launch of the partials kernel takes: 32 / U_p owner lanes a unit
// in each of its kWarps warps
int partials_max_rows(int U) {
  int up = 1;
  while (up < U) up <<= 1;
  return kWarps * (32 / up);
}

template <int KPT, bool kExchangeOnly>
int launch_partials(const void* gates, const void* masks, const void* c0, const void* w_hh_t,
                    const void* g_outs, const void* g_hT, const void* g_cT, void* d_gates,
                    void* d_h0, void* d_c0, void* cs, void* d_h_tilde, void* d_c_tilde,
                    void* ws, int T, int B, int H, int U, int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  void* args[] = {&gates, &masks, &c0,   &w_hh_t,    &g_outs,    &g_hT, &g_cT,
                  &d_gates, &d_h0, &d_c0, &cs, &d_h_tilde, &d_c_tilde, &ws,
                  &T,     &B,     &H,    &U};
  return cooperative_launch((const void*)lstm_seq_backward_partials_kernel<KPT, kExchangeOnly>,
                            capacity, dev, H, U, partials_smem_bytes(B), args, stream);
}

template <bool kExchangeOnly>
int launch_partials_any(const void* gates, const void* masks, const void* c0,
                        const void* w_hh_t, const void* g_outs, const void* g_hT,
                        const void* g_cT, void* d_gates, void* d_h0, void* d_c0, void* cs,
                        void* d_h_tilde, void* d_c_tilde, void* ws, int T, int B, int H,
                        int U, int dev, void* stream) {
  if (U < 1 || U > kMaxUnits || B < 1 || B > partials_max_rows(U))
    return (int)cudaErrorInvalidValue;
#define LSTM_SEQ_PARTIALS_KPT(kpt)                                                           \
  case kpt:                                                                                  \
    return launch_partials<kpt, kExchangeOnly>(gates, masks, c0, w_hh_t, g_outs, g_hT, g_cT, \
                                               d_gates, d_h0, d_c0, cs, d_h_tilde,           \
                                               d_c_tilde, ws, T, B, H, U, dev, stream);
  switch ((H + kThreads - 1) / kThreads) {
    LSTM_SEQ_PARTIALS_KPT(1)
    LSTM_SEQ_PARTIALS_KPT(2)
    LSTM_SEQ_PARTIALS_KPT(3)
    LSTM_SEQ_PARTIALS_KPT(4)
  }
#undef LSTM_SEQ_PARTIALS_KPT
  return (int)cudaErrorInvalidValue;
}

// The tensor map through which the wide kernels' rings copy W_hh^T (4H, H):
// 3 dimensions (k: H, unit: H, gate: 4), boxes of (128, 1, 4) floats, 2
// KiB, entries past H filled with zeros.  The encoder is looked up at run
// time (cudaGetDriverEntryPoint), so the library links nothing more.  A
// zeroed map for the exchange-only instances.
cudaError_t wide_w_map(const void* w_hh_t, int H, CUtensorMap* map) {
  *map = CUtensorMap{};
  if (w_hh_t == nullptr) return cudaSuccess;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) == cudaSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    cudaGetLastError();
  });
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)H, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)H * sizeof(float),
                                 (cuuint64_t)H * H * sizeof(float)};
  const cuuint32_t box[3] = {128, 1, 4}, elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w_hh_t),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wide forward's shared memory (wide_forward_smem_bytes): the rings
// (when items are left past registers and shared memory), the items in
// shared memory (smem_pc pair-chunks of 8 warps x 2 items, returned), one
// buffer of h (B, H), the sums (8 warps x 8R), the rings' mbarriers; 0
// where h, the sums, the mbarriers and the rings do not fit: the direct wide
// kernel (lstm_seq_wide_direct_kernel) takes those shapes.
size_t wide_forward_smem(int B, int H, int U, int* smem_pc) {
  const int R = wide_rows(B), KC = (H / 4 + 31) / 32, slots = (U + kWarps - 1) / kWarps;
  const int reg_pc = KC < fwd_reg_chunks(R) ? KC : fwd_reg_chunks(R);
  const int rest = (slots + 1) / 2 * KC - reg_pc;
  const size_t fixed = (size_t)B * H * sizeof(float) + (size_t)kWarps * 8 * R * sizeof(float) +
                       kWideBarBytes;
  const size_t per_pc = (size_t)kWarps * 2 * kItemBytes;
  if (fixed + kWideRingBytes > (size_t)kMaxSmem) return 0;
  if (fixed + rest * per_pc <= (size_t)kMaxSmem) {  // everything on chip: no ring
    *smem_pc = rest;
    return fixed + rest * per_pc;
  }
  *smem_pc = (int)(((size_t)kMaxSmem - fixed - kWideRingBytes) / per_pc);
  return fixed + kWideRingBytes + *smem_pc * per_pc;
}

// The wide backward's shared memory at C blocks a cluster: the rings, the
// items (smem_items of 8 warps, returned), the block's partials (B, H) if C
// > 1, its cells' dg (2 x U x 4 x R), the mbarriers; 0 where they do not fit
size_t wide_backward_smem(int B, int H, int U, int C, int* smem_items) {
  const int R = wide_rows(B), KI = (H / 4 + kThreads - 1) / kThreads;
  const int rest = KI * U - (U < bwd_reg_units(R) ? U : bwd_reg_units(R));
  const size_t fixed = (C > 1 ? (size_t)B * H * sizeof(float) : 0) +
                       2 * (size_t)U * 4 * R * sizeof(float) + kWideBarBytes;
  const size_t per_item = (size_t)kWarps * kItemBytes;
  if (fixed + kWideRingBytes > (size_t)kMaxSmem) return 0;
  if (fixed + rest * per_item <= (size_t)kMaxSmem) {
    *smem_items = rest;
    return fixed + rest * per_item;
  }
  *smem_items = (int)(((size_t)kMaxSmem - fixed - kWideRingBytes) / per_item);
  return fixed + kWideRingBytes + *smem_items * per_item;
}

// The direct wide forward's shared memory: as many items of W_hh as fit
size_t wide_direct_smem_bytes(int H, int U, int* smem_items) {
  const int KC = (H / 4 + 31) / 32, slots = (U + kWarps - 1) / kWarps;
  const int items = slots * KC - (KC < kDirectRegChunks ? KC : kDirectRegChunks);
  const size_t fit = (size_t)kMaxSmem / kDirectItemBytes;
  *smem_items = (size_t)items < fit ? items : (int)fit;
  return (size_t)*smem_items * kDirectItemBytes;
}

template <int R, bool kExchangeOnly>
int launch_wide_rows(const void* gates_x, const void* masks, const void* h0, const void* c0,
                     const void* w_hh_t, void* outs, void* hT, void* cT, void* ws, int T, int B,
                     int H, int U, int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  int smem_pc = 0;
  const size_t smem = wide_forward_smem(B, H, U, &smem_pc);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap w_map;
  const cudaError_t err = wide_w_map(w_hh_t, H, &w_map);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&gates_x, &masks, &h0, &c0, &w_hh_t, &w_map, &outs, &hT, &cT, &ws,
                  &T,       &B,     &H,  &U,  &smem_pc};
  return cooperative_launch((const void*)lstm_seq_wide_kernel<R, kExchangeOnly>, capacity, dev,
                            H, U, smem, args, stream);
}

template <bool kExchangeOnly>
int launch_wide(const void* gates_x, const void* masks, const void* h0, const void* c0,
                const void* w_hh_t, void* outs, void* hT, void* cT, void* ws, int T, int B,
                int H, int U, int dev, void* stream) {
  if (B < 1 || B > kWideRows || H % 4 || U < 1) return (int)cudaErrorInvalidValue;
  if (wide_rows(B) == 4)
    return launch_wide_rows<4, kExchangeOnly>(gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws,
                                              T, B, H, U, dev, stream);
  return launch_wide_rows<kWideRows, kExchangeOnly>(gates_x, masks, h0, c0, w_hh_t, outs, hT,
                                                    cT, ws, T, B, H, U, dev, stream);
}

int launch_wide_direct(const void* gates_x, const void* masks, const void* h0, const void* c0,
                       const void* w_hh_t, void* outs, void* hT, void* cT, void* ws, int T,
                       int B, int H, int U, int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  if (B < 1 || B > kWideRows || H % 4 || U < 1) return (int)cudaErrorInvalidValue;
  int smem_items = 0;
  const size_t smem = wide_direct_smem_bytes(H, U, &smem_items);
  void* args[] = {&gates_x, &masks, &h0, &c0, &w_hh_t, &outs, &hT, &cT, &ws,
                  &T,       &B,     &H,  &U,  &smem_items};
  return cooperative_launch((const void*)lstm_seq_wide_direct_kernel, capacity, dev, H, U, smem,
                            args, stream);
}

// Clusters of the wide backward on one device, found on its first launch
// there: for each size of kWideClusters, how many clusters of that size fit
// co-resident at kMaxSmem (cudaOccupancyMaxActiveClusters), beside the
// Capacity of a grid without clusters.
struct ClusterCapacity {
  std::once_flag once;
  int clusters[sizeof(kWideClusters) / sizeof(int)] = {};
};

// The cluster size a launch of the wide backward over (B, H) at U units a
// block takes, and its shared memory: the first of kWideClusters whose grid
// (ceil(H / U) blocks rounded up to whole clusters) fits co-resident in the
// device's clusters at that size, with the block's partials in shared
// memory; 1 (no cluster) otherwise.  Picked by shape and device, before the
// launch.
int wide_backward_cluster(const void* kernel, ClusterCapacity* capacity, int dev, int B, int H,
                          int U, int* smem_items, size_t* smem) {
  ClusterCapacity& cap = capacity[dev];
  std::call_once(cap.once, [&] {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
        cudaSuccess) {
      cudaGetLastError();
      return;
    }
    for (size_t k = 0; k < sizeof(kWideClusters) / sizeof(int); ++k) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kWideClusters[k];
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(kWideClusters[k]);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = kMaxSmem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();  // no clusters of this size: the next size, or none
        n = 0;
      }
      cap.clusters[k] = n;
    }
  });
  const int blocks = (H + U - 1) / U;
  for (size_t k = 0; k < sizeof(kWideClusters) / sizeof(int); ++k) {
    const int C = kWideClusters[k], grid = (blocks + C - 1) / C * C;
    const size_t bytes = wide_backward_smem(B, H, U, C, smem_items);
    if (bytes != 0 && grid <= cap.clusters[k] * C) {
      *smem = bytes;
      return C;
    }
  }
  *smem = wide_backward_smem(B, H, U, 1, smem_items);
  return 1;
}

template <int R, bool kExchangeOnly>
int launch_partials_wide_rows(const void* gates, const void* masks, const void* c0,
                              const void* w_hh_t, const void* g_outs, const void* g_hT,
                              const void* g_cT, void* d_gates, void* d_h0, void* d_c0, void* cs,
                              void* d_h_tilde, void* d_c_tilde, void* ws, int T, int B, int H,
                              int U, int dev, void* stream, int* cluster) {
  static Capacity capacity[kMaxDevices];
  static ClusterCapacity clusters[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const void* kernel = (const void*)lstm_seq_backward_partials_wide_kernel<R, kExchangeOnly>;
  int smem_items = 0;
  size_t smem = 0;
  const int C = wide_backward_cluster(kernel, clusters, dev, B, H, U, &smem_items, &smem);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (cluster) {  // the query alone
    *cluster = C;
    return 0;
  }
  CUtensorMap w_map;
  const cudaError_t err = wide_w_map(w_hh_t, H, &w_map);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&gates, &masks, &c0, &w_hh_t, &w_map, &g_outs, &g_hT, &g_cT, &d_gates, &d_h0,
                  &d_c0,  &cs,    &d_h_tilde, &d_c_tilde, &ws, &T, &B, &H, &U, &smem_items};
  return cooperative_launch(kernel, capacity, dev, H, U, smem, args, stream, C);
}

template <bool kExchangeOnly>
int launch_partials_wide(const void* gates, const void* masks, const void* c0,
                         const void* w_hh_t, const void* g_outs, const void* g_hT,
                         const void* g_cT, void* d_gates, void* d_h0, void* d_c0, void* cs,
                         void* d_h_tilde, void* d_c_tilde, void* ws, int T, int B, int H, int U,
                         int dev, void* stream, int* cluster = nullptr) {
  if (B < 1 || B > kWideRows || H % 4 || U < 1) return (int)cudaErrorInvalidValue;
  if (wide_rows(B) == 4)
    return launch_partials_wide_rows<4, kExchangeOnly>(
        gates, masks, c0, w_hh_t, g_outs, g_hT, g_cT, d_gates, d_h0, d_c0, cs, d_h_tilde,
        d_c_tilde, ws, T, B, H, U, dev, stream, cluster);
  return launch_partials_wide_rows<kWideRows, kExchangeOnly>(
      gates, masks, c0, w_hh_t, g_outs, g_hT, g_cT, d_gates, d_h0, d_c0, cs, d_h_tilde,
      d_c_tilde, ws, T, B, H, U, dev, stream, cluster);
}

}  // namespace

extern "C" size_t lstm_seq_smem_bytes(int B, int H) { return smem_bytes(B, H); }

extern "C" size_t lstm_seq_backward_smem_bytes(int B, int H) {
  return backward_smem_bytes(B, H);
}

extern "C" size_t lstm_seq_backward_partials_smem_bytes(int B) {
  return partials_smem_bytes(B);
}

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

// The backward over the same grid: the shapes of lstm_seq_f32, with at most
// as many batch rows as two buffers of dg leave room for (the wrapper
// checks).  d_h_tilde and d_c_tilde may be null.
extern "C" int lstm_seq_backward_f32(const void* gates, const void* masks, const void* c0,
                                     const void* w_hh, const void* g_outs, const void* g_hT,
                                     const void* g_cT, void* d_gates, void* d_h0, void* d_c0,
                                     void* cs, void* d_h_tilde, void* d_c_tilde, void* ws,
                                     int T, int B, int H, int U, int dev, void* stream) {
#define LSTM_SEQ_BWD_KC(kc)                                                            \
  case kc:                                                                             \
    return launch_backward<kc, false>(gates, masks, c0, w_hh, g_outs, g_hT, g_cT, d_gates,  \
                                      d_h0, d_c0, cs, d_h_tilde, d_c_tilde, ws, T, B, H, U, \
                                      dev, stream);
  switch ((H + 127) / 128) {
    LSTM_SEQ_BWD_KC(1)
    LSTM_SEQ_BWD_KC(2)
    LSTM_SEQ_BWD_KC(3)
    LSTM_SEQ_BWD_KC(4)
    LSTM_SEQ_BWD_KC(5)
    LSTM_SEQ_BWD_KC(6)
    LSTM_SEQ_BWD_KC(7)
    LSTM_SEQ_BWD_KC(8)
  }
#undef LSTM_SEQ_BWD_KC
  return (int)cudaErrorInvalidValue;
}

// The dg-exchange backward's grid running T stages of nothing but its
// exchange (every block publishes its cells' dg and reads the whole dg
// back, all zeros): the floor under its step.
extern "C" int lstm_seq_backward_exchange(void* ws, int T, int B, int H, int U, int dev,
                                          void* stream) {
  return launch_backward<1, true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, ws, T, B,
                                  H, U, dev, stream);
}

// The backward that exchanges partial sums: the shapes of lstm_seq_f32 (H a
// multiple of 4 up to 1024, U <= 8 units a block), w_hh_t = W_hh^T (4H, H),
// at most 8 · 32 / U_p batch rows (U_p: U rounded up to a power of 2), and
// a workspace of 2 + 2 · ceil(H / U) · B · H words.  d_h_tilde and
// d_c_tilde may be null.
extern "C" int lstm_seq_backward_partials_f32(const void* gates, const void* masks,
                                              const void* c0, const void* w_hh_t,
                                              const void* g_outs, const void* g_hT,
                                              const void* g_cT, void* d_gates, void* d_h0,
                                              void* d_c0, void* cs, void* d_h_tilde,
                                              void* d_c_tilde, void* ws, int T, int B, int H,
                                              int U, int dev, void* stream) {
  return launch_partials_any<false>(gates, masks, c0, w_hh_t, g_outs, g_hT, g_cT, d_gates,
                                    d_h0, d_c0, cs, d_h_tilde, d_c_tilde, ws, T, B, H, U, dev,
                                    stream);
}

// Its grid running T stages of nothing but its exchange (the partials
// published as zeros, and each owner's read back): the floor under its step.
extern "C" int lstm_seq_backward_partials_exchange(void* ws, int T, int B, int H, int U,
                                                   int dev, void* stream) {
  return launch_partials_any<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, ws, T, B, H, U, dev, stream);
}

// The forward past H = 1024 or 8 units a block (H a multiple of 4, any U,
// at most kWideRows batch rows; the wrapper pads H and slices the batch) at
// the shapes whose shared memory lstm_seq_wide_smem_bytes gives: the
// arguments of lstm_seq_f32
extern "C" int lstm_seq_wide_f32(const void* gates_x, const void* masks, const void* h0,
                                 const void* c0, const void* w_hh_t, void* outs, void* hT,
                                 void* cT, void* ws, int T, int B, int H, int U, int dev,
                                 void* stream) {
  return launch_wide<false>(gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws, T, B, H, U, dev,
                            stream);
}

// The wide forward's grid running T steps of nothing but the h exchange
extern "C" int lstm_seq_wide_exchange(void* ws, int T, int B, int H, int U, int dev,
                                      void* stream) {
  return launch_wide<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, ws, T, B, H, U, dev, stream);
}

// The wide forward's shared memory at (B, H, U); 0 where it does not fit,
// the shapes of lstm_seq_wide_direct_f32
extern "C" size_t lstm_seq_wide_smem_bytes(int B, int H, int U) {
  int smem_pc = 0;
  return wide_forward_smem(B, H, U, &smem_pc);
}

// The direct wide forward, whose lanes read h from the exchange's words: the
// arguments of lstm_seq_wide_f32, at any H a multiple of 4
extern "C" int lstm_seq_wide_direct_f32(const void* gates_x, const void* masks, const void* h0,
                                        const void* c0, const void* w_hh_t, void* outs,
                                        void* hT, void* cT, void* ws, int T, int B, int H,
                                        int U, int dev, void* stream) {
  return launch_wide_direct(gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws, T, B, H, U, dev,
                            stream);
}

// The partials backward past H = 1024 or 8 units a block: the arguments of
// lstm_seq_backward_partials_f32, at most kWideRows batch rows, on the
// forward's grid rounded up to whole clusters, and a workspace of 2 + 2 ·
// ceil(H / U) · B · H words
extern "C" int lstm_seq_backward_partials_wide_f32(
    const void* gates, const void* masks, const void* c0, const void* w_hh_t,
    const void* g_outs, const void* g_hT, const void* g_cT, void* d_gates, void* d_h0,
    void* d_c0, void* cs, void* d_h_tilde, void* d_c_tilde, void* ws, int T, int B, int H,
    int U, int dev, void* stream) {
  return launch_partials_wide<false>(gates, masks, c0, w_hh_t, g_outs, g_hT, g_cT, d_gates,
                                     d_h0, d_c0, cs, d_h_tilde, d_c_tilde, ws, T, B, H, U, dev,
                                     stream);
}

// Its grid running T stages of nothing but its exchange: the partials
// published as zeros (through the cluster's sums where it has clusters),
// and each owner's read back
extern "C" int lstm_seq_backward_partials_wide_exchange(void* ws, int T, int B, int H, int U,
                                                        int dev, void* stream) {
  return launch_partials_wide<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, ws, T, B, H, U, dev, stream);
}

// The cluster size that a launch of the wide backward over (B, H) at U
// units a block on device dev takes (1: no cluster), or minus a CUDA error
extern "C" int lstm_seq_backward_partials_wide_cluster(int B, int H, int U, int dev) {
  int cluster = 0;
  const int err = launch_partials_wide<false>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                              nullptr, nullptr, nullptr, nullptr, nullptr,
                                              nullptr, nullptr, nullptr, nullptr, 1, B, H, U,
                                              dev, nullptr, &cluster);
  return err ? -err : cluster;
}
