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
// Past H = 1024 or 8 units a block, variants of the forward and of the
// partials backward run the same grid with W_hh split between registers,
// shared memory and L2 (lstm_seq_wide_kernel and
// lstm_seq_backward_partials_wide_kernel; their note says how).  H off a
// multiple of 4 is padded by the wrapper, so every H has a route.
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
// block: H = 2048 on 132 SMs needs 16, and 512 on a card of 60 SMs 9),
// these variants run the same recurrence over the same grid of ceil(H / U)
// co-resident blocks, one an SM, with the exchanges, tags and epoch of the
// kernels above.  W_hh of the block's units is split three ways, in a
// fixed order of items: what fits in registers (kWideRegChunks chunks of a
// lane's first unit in the forward, kWideRegK entries of 8 units a thread
// in the backward), then as many items as the shared memory left over
// holds, copied there once a launch, then the rest read each step from
// global memory through L2.  At H = 2048 W_hh is 64 MiB, more than the
// register files and shared memory of 132 SMs hold (about 62 MiB) and
// than L2 (50 MB), so most of it streams each step: 20 µs at 3.35 TB/s
// for the whole of it, the floor under a step, against 4 µs of float32
// operations; the reads from L2 go kWideBatch chunks or units at a time,
// so that their latencies overlap.  A launch takes at most kWideRows batch rows (a larger
// batch runs as launches over slices of rows), so a warp keeps the sums
// of every row for a chunk of W_hh read once.

constexpr int kWideRows = 8;          // batch rows one launch of a wide variant takes
constexpr int kWidePairs = kWideRows / kTaskBatch;
constexpr int kWideRegChunks = 4;     // forward: chunks of the lane's first unit in registers
constexpr int kWideRegK = 2;          // backward: entries k of 8 units a thread in registers
constexpr int kWideRegUnits = 8;
constexpr int kWideBatch = 4;         // chunks (forward) or units (backward) read from L2 at once
constexpr size_t kWideItemBytes = (size_t)kWarps * 4 * 32 * sizeof(float4);  // forward item

// h of step t-1 for one chunk (4 units) of one row, straight from the
// exchange's tagged words (kDirect), reloading until all four carry tag
// ``want``
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

// The forward past H = 1024 or 8 units a block.  Warp w takes the units
// w, w + 8, ... of its block (slots s = 0, 1, ...), one after another, and
// all batch pairs of each; lane b owns the cell (row b, the slot's unit),
// so B <= kWideRows.  For each chunk c = lane + 32j of W_hh's four gate
// rows of the unit (read once, from registers, shared memory or L2, the
// items in slot-major, then chunk order) the lane adds its products with
// every pair's h rows, chunk by chunk in increasing j, the four values of
// a chunk in turn, as the kernel above does; the same xor tree sums the
// lanes.  The owner reads gates_x, the mask and c_{t-1} (kept in cT, which
// only it writes) at the slot's start, so the loads are in flight during
// the product.  h of the step before comes into shared memory, as above;
// where two buffers of it do not fit (kDirect: H above about 14,500 at one
// row), each lane reads the words it multiplies from the exchange itself,
// waiting on their tags: every warp reads all of h_{t-1} before it
// publishes h_t, so the two buffers stay safe without a block barrier.
template <bool kDirect>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_wide_kernel(const float* __restrict__ gates_x,  // (T, B, 4H)
                     const float* __restrict__ masks,    // (T, B)
                     const float* __restrict__ h0,       // (B, H)
                     const float* __restrict__ c0,       // (B, H)
                     const float* __restrict__ w_hh_t,   // (4H, H): row = gate*H + unit
                     float* __restrict__ outs,           // (T, B, H)
                     float* __restrict__ hT,             // (B, H)
                     float* cT,                          // (B, H): c of the last step so far
                     u64* ws, int T, int B, int H, int U, int smem_items) {
  extern __shared__ float4 smem4[];
  const int b_pad = (B + kTaskBatch - 1) / kTaskBatch * kTaskBatch;
  float* h_s = reinterpret_cast<float*>(smem4);  // 2 x (b_pad, H) unless kDirect
  float4* w_s = smem4 + (kDirect ? 0 : (size_t)b_pad * H / 2);  // (warps, items, 4 gates, 32 lanes)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * U;
  const int BH = B * H, chunks = H / 4, KC = (chunks + 31) / 32, pairs = b_pad / kTaskBatch;
  const int slots = (U + kWarps - 1) / kWarps;
  const int reg_chunks = KC < kWideRegChunks ? KC : kWideRegChunks;
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

  float4 wr[4][kWideRegChunks];  // slot 0's chunks lane + 32j, j < kWideRegChunks
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int j = 0; j < kWideRegChunks; ++j) {
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
  if (!kDirect)
    for (int i = tid; i < 2 * b_pad * H; i += kThreads) h_s[i] = i < BH ? __ldg(h0 + i) : 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hb_s = h_s + (t & 1) * b_pad * H;
    const u64* src = xbuf + (size_t)((t - 1) & 1) * BH;  // h_{t-1}'s words (t > 0)
    const unsigned want = tag0 + (unsigned)(t - 1);
    if (!kDirect) {
      if (t > 0) {  // h of step t-1 from every block, as in lstm_seq_kernel
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
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            const int i = base + j * kThreads;
            if (i < BH) dst_s[i] = __uint_as_float((unsigned)v[j]);
          }
        }
      }
      __syncthreads();
    }
    // rows r of h_{t-1} at chunk c: zero past B
    auto h4 = [&](int r, int c) {
      if (!kDirect) return reinterpret_cast<const float4*>(hb_s + (size_t)r * H)[c];
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
      float acc[kWidePairs][4 * kTaskBatch];  // acc[pair][gate * 2 + i]
#pragma unroll
      for (int p = 0; p < kWidePairs; ++p)
#pragma unroll
        for (int j = 0; j < 4 * kTaskBatch; ++j) acc[p][j] = 0.0f;
      auto chunk = [&](int c, const float4 (&wv)[4]) {
#pragma unroll
        for (int p = 0; p < kWidePairs; ++p) {
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
        for (int j = 0; j < kWideRegChunks; ++j) {
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
      // the rest from L2, kBatch chunks' loads in flight at once (one with
      // kDirect, whose spinning reads of h need the registers)
      constexpr int kBatch = kDirect ? 1 : kWideBatch;
      for (; j < KC; j += kBatch) {
        float4 wv[kBatch][4];
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          const int c = lane + 32 * (j + jj);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            wv[jj][gate] = j + jj < KC && c < chunks ? __ldg(w_row(gate, s) + c)
                                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          const int c = lane + 32 * (j + jj);
          if (j + jj < KC && c < chunks) chunk(c, wv[jj]);
        }
      }
      // each pair's sums over the lanes (the xor tree of lstm_seq_kernel);
      // lane 2p + i keeps the four gate sums of its cell in g
      float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < kWidePairs; ++p) {
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
// lstm_seq_backward_partials_kernel, over any U.  A cell (row b, unit u)
// of the block is handled by a group of G lanes (G a power of 2, up to 32,
// as many as 256 threads give every cell of the block at once, in rounds
// past that): the group gathers dh~_{t+1} of the cell, the partials of
// every block split among its lanes and summed by an xor tree, and its
// first lane (the owner) runs the cell's step.  The owner keeps nothing in
// registers across steps: it reads the step's inputs and the mask of the
// step after at use, and keeps dc~ of the step after in d_c0 (its own
// words; d_c0 gets its value at the end).  Then every thread forms, for its
// entries k = tid + 256·i of W_hh's rows and every row b, the block's
// partial sum over its 4U columns of W_hh, unit by unit, the four gates in
// turn, and publishes it; the entries come from registers (i <
// kWideRegK, the first 8 units), then shared memory, then L2, in that
// item order (i, then u).  B <= kWideRows.
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_backward_partials_wide_kernel(const float* __restrict__ gates,   // (T, B, 4H)
                                       const float* __restrict__ masks,   // (T, B)
                                       const float* __restrict__ c0,      // (B, H)
                                       const float* __restrict__ w_hh_t,  // (4H, H)
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
  extern __shared__ float4 smem4[];
  float* dg_s = reinterpret_cast<float*>(smem4);  // 2 x (B, 4 gates, U): the block's cells' dg
  float* w_s = dg_s + 2 * (size_t)B * 4 * U;      // (items, 4 gates, kThreads)
  const int tid = threadIdx.x, lane = tid & 31;
  const int blocks = gridDim.x, unit0 = blockIdx.x * U;
  const int BH = B * H, G4 = 4 * H, KPT = (H + kThreads - 1) / kThreads;
  const size_t slab = (size_t)blocks * BH;  // one buffer of partials: (blocks, B, H)
  const unsigned tag0 = (unsigned)load_word(ws) + 1u;
  u64* xbuf = ws + 2;
  const int cells = B * U;
  int lanes = 32;  // G: lanes a cell
  while (lanes > 1 && cells * lanes > kThreads) lanes >>= 1;
  const int per_round = kThreads / lanes, sub = lane & (lanes - 1);
  const int reg_units = U < kWideRegUnits ? U : kWideRegUnits;
  const int reg_k = KPT < kWideRegK ? KPT : kWideRegK;
  // item (i, u) of W_hh^T's entries past the registers' (i < kWideRegK, u <
  // kWideRegUnits), in (i, u) order: its place in shared memory if below
  // smem_items
  auto item_of = [&](int i, int u) {
    return i < reg_k ? i * (U - reg_units) + (u - reg_units)
                     : reg_k * (U - reg_units) + (i - reg_k) * U + u;
  };
  auto w_at = [&](int i, int gate, int u) {  // W_hh^T[gate·H + unit0 + u, tid + 256 i]
    const int k = tid + kThreads * i;
    return k < H && unit0 + u < H ? __ldg(w_hh_t + (size_t)(gate * H + unit0 + u) * H + k) : 0.0f;
  };

  float wr[kWideRegK][4][kWideRegUnits];
#pragma unroll
  for (int i = 0; i < kWideRegK; ++i)
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int u = 0; u < kWideRegUnits; ++u)
        wr[i][gate][u] = i < reg_k && u < reg_units ? w_at(i, gate, u) : 0.0f;
  for (int i = 0; i < KPT; ++i)
    for (int u = i < reg_k ? reg_units : 0; u < U; ++u) {
      const int item = item_of(i, u);
      if (item >= smem_items) break;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        w_s[((size_t)item * 4 + gate) * kThreads + tid] = w_at(i, gate, u);
    }
  for (int i = tid; i < 2 * B * 4 * U; i += kThreads) dg_s[i] = 0.0f;

  // c_t of each cell the thread owns, t = 0 .. T-1, into cs
  for (int base = 0; base < cells; base += per_round) {
    const int ci = base + tid / lanes, b = ci / U, unit = unit0 + ci % U;
    if (sub != 0 || ci >= cells || unit >= H) continue;
    const size_t cell = (size_t)b * H + unit;
    float c = __ldg(c0 + cell);
    for (int t = 0; t < T; ++t) {
      const float* p = gates + ((size_t)t * B + b) * G4 + unit;
      const float m = __ldg(masks + (size_t)t * B + b);
      c = sigmoid_fast(__ldg(p + H)) * (c * m) +
          sigmoid_fast(__ldg(p)) * tanh_fast(__ldg(p + 2 * H));
      cs[(size_t)t * BH + cell] = c;
    }
  }
  __syncthreads();

  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s, par = s & 1;
    const u64* src = xbuf + (size_t)((s - 1) & 1) * slab;
    const unsigned want = tag0 + (unsigned)(s - 1);
    for (int base = 0; base < cells; base += per_round) {  // uniform
      const int ci = base + tid / lanes, b = ci / U, u = ci % U, unit = unit0 + u;
      const bool valid = ci < cells && unit < H;
      float dht = 0.0f;
      if (s > 0) {
        // dh~_{t+1} of the cell: the partials of every block, split among
        // the group's lanes, kPartialsInFlight at a time
        const u64* at = src + (size_t)b * H + unit;
        for (int r0 = 0; lanes * r0 < blocks; r0 += kPartialsInFlight) {
          u64 v[kPartialsInFlight];
#pragma unroll
          for (int j = 0; j < kPartialsInFlight; ++j) {
            const int blk = sub + lanes * (r0 + j);
            v[j] = valid && blk < blocks ? load_word(at + (size_t)blk * BH) : (u64)want << 32;
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
      if (sub != 0 || !valid) continue;
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
      float* mine = dg_s + ((size_t)par * B + b) * 4 * U + u;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        out[gate * H] = dg[gate];
        mine[gate * U] = dg[gate];
      }
      d_c0[cell] = dc * fg;
      if (d_c_tilde) d_c_tilde[(size_t)t * BH + cell] = dc * fg;
    }
    if (s == T) break;
    __syncthreads();

    // the block's partials of dh~_t for every row and entry k; publish them
    u64* dst = xbuf + (size_t)par * slab + (size_t)blockIdx.x * BH;
    const u64 tag = (u64)(tag0 + (unsigned)s) << 32;
    const float* dgp = dg_s + (size_t)par * B * 4 * U;
    for (int i = 0; i < KPT; ++i) {
      const int k = tid + kThreads * i;
      float acc[kWideRows];
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) acc[r] = 0.0f;
      auto add = [&](int u, const float (&w4)[4]) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int r = 0; r < kWideRows; ++r)
            if (r < B) acc[r] = fmaf(w4[gate], dgp[((size_t)r * 4 + gate) * U + u], acc[r]);
      };
#pragma unroll
      for (int ri = 0; ri < kWideRegK; ++ri)
        if (ri == i) {
#pragma unroll
          for (int u = 0; u < kWideRegUnits; ++u)
            if (u < reg_units) {
              const float w4[4] = {wr[ri][0][u], wr[ri][1][u], wr[ri][2][u], wr[ri][3][u]};
              add(u, w4);
            }
        }
      int u = i < reg_k ? reg_units : 0;
      for (; u < U && item_of(i, u) < smem_items; ++u) {
        const float* ws = w_s + (size_t)item_of(i, u) * 4 * kThreads + tid;
        const float w4[4] = {ws[0], ws[kThreads], ws[2 * kThreads], ws[3 * kThreads]};
        add(u, w4);
      }
      // the rest from L2, kWideBatch units' loads in flight at once
      for (; u < U; u += kWideBatch) {
        float w4[kWideBatch][4];
#pragma unroll
        for (int uu = 0; uu < kWideBatch; ++uu)
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            w4[uu][gate] = u + uu < U ? w_at(i, gate, u + uu) : 0.0f;
#pragma unroll
        for (int uu = 0; uu < kWideBatch; ++uu)
          if (u + uu < U) add(u + uu, w4[uu]);
      }
      if (k < H)
        for (int r = 0; r < B; ++r)
          store_word(dst + (size_t)r * H + k, tag | __float_as_uint(acc[r]));
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

// One cooperative launch of ceil(H / U) blocks of `kernel`, whose
// per-device capacity is kept in `capacity`.
int cooperative_launch(const void* kernel, Capacity* capacity, int dev, int H, int U,
                       size_t smem, void** args, void* stream) {
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
  const int blocks = (H + U - 1) / U;
  if (cap.blocks < blocks) return kNotCoResident;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
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

// The wide forward's shared memory: two buffers of h unless they do not fit
// (then kDirect), then as many items of W_hh as fit (smem_items, returned)
size_t wide_smem_bytes(int B, int H, int U, bool* direct, int* smem_items) {
  const size_t staged = smem_bytes(B, H);
  *direct = staged > (size_t)kMaxSmem;
  const size_t base = *direct ? 0 : staged;
  const int KC = (H / 4 + 31) / 32, slots = (U + kWarps - 1) / kWarps;
  const int items = slots * KC - (KC < kWideRegChunks ? KC : kWideRegChunks);
  const size_t fit = ((size_t)kMaxSmem - base) / kWideItemBytes;
  *smem_items = (size_t)items < fit ? items : (int)fit;
  return base + (size_t)*smem_items * kWideItemBytes;
}

int launch_wide(const void* gates_x, const void* masks, const void* h0, const void* c0,
                const void* w_hh_t, void* outs, void* hT, void* cT, void* ws, int T, int B,
                int H, int U, int dev, void* stream) {
  static Capacity staged_capacity[kMaxDevices], direct_capacity[kMaxDevices];
  if (B < 1 || B > kWideRows || H % 4 || U < 1) return (int)cudaErrorInvalidValue;
  bool direct = false;
  int smem_items = 0;
  const size_t smem = wide_smem_bytes(B, H, U, &direct, &smem_items);
  void* args[] = {&gates_x, &masks, &h0, &c0, &w_hh_t, &outs, &hT, &cT, &ws,
                  &T,       &B,     &H,  &U,  &smem_items};
  if (direct)
    return cooperative_launch((const void*)lstm_seq_wide_kernel<true>, direct_capacity, dev, H,
                              U, smem, args, stream);
  return cooperative_launch((const void*)lstm_seq_wide_kernel<false>, staged_capacity, dev, H,
                            U, smem, args, stream);
}

// The wide partials backward's shared memory: two buffers of the block's
// cells' dg, then as many items of W_hh^T (4 gates × kThreads entries) as
// fit (smem_items, returned); 0 where even the dg does not fit
size_t partials_wide_smem_bytes(int B, int H, int U, int* smem_items) {
  const size_t dg = 2 * (size_t)B * 4 * U * sizeof(float);
  if (dg > (size_t)kMaxSmem) return 0;
  const int KPT = (H + kThreads - 1) / kThreads;
  const int items = KPT * U - (KPT < kWideRegK ? KPT : kWideRegK) *
                                  (U < kWideRegUnits ? U : kWideRegUnits);
  const size_t fit = ((size_t)kMaxSmem - dg) / (4 * kThreads * sizeof(float));
  *smem_items = (size_t)items < fit ? items : (int)fit;
  return dg + (size_t)*smem_items * 4 * kThreads * sizeof(float);
}

int launch_partials_wide(const void* gates, const void* masks, const void* c0,
                         const void* w_hh_t, const void* g_outs, const void* g_hT,
                         const void* g_cT, void* d_gates, void* d_h0, void* d_c0, void* cs,
                         void* d_h_tilde, void* d_c_tilde, void* ws, int T, int B, int H, int U,
                         int dev, void* stream) {
  static Capacity capacity[kMaxDevices];
  if (B < 1 || B > kWideRows || H % 4 || U < 1) return (int)cudaErrorInvalidValue;
  int smem_items = 0;
  const size_t smem = partials_wide_smem_bytes(B, H, U, &smem_items);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&gates, &masks, &c0, &w_hh_t, &g_outs, &g_hT, &g_cT, &d_gates, &d_h0,
                  &d_c0,  &cs,    &d_h_tilde, &d_c_tilde, &ws, &T, &B, &H, &U, &smem_items};
  return cooperative_launch((const void*)lstm_seq_backward_partials_wide_kernel, capacity, dev,
                            H, U, smem, args, stream);
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
// at most kWideRows batch rows; the wrapper pads H and slices the batch):
// the arguments of lstm_seq_f32
extern "C" int lstm_seq_wide_f32(const void* gates_x, const void* masks, const void* h0,
                                 const void* c0, const void* w_hh_t, void* outs, void* hT,
                                 void* cT, void* ws, int T, int B, int H, int U, int dev,
                                 void* stream) {
  return launch_wide(gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws, T, B, H, U, dev, stream);
}

// The partials backward past H = 1024 or 8 units a block: the arguments of
// lstm_seq_backward_partials_f32, at most kWideRows batch rows
extern "C" int lstm_seq_backward_partials_wide_f32(
    const void* gates, const void* masks, const void* c0, const void* w_hh_t,
    const void* g_outs, const void* g_hT, const void* g_cT, void* d_gates, void* d_h0,
    void* d_c0, void* cs, void* d_h_tilde, void* d_c_tilde, void* ws, int T, int B, int H,
    int U, int dev, void* stream) {
  return launch_partials_wide(gates, masks, c0, w_hh_t, g_outs, g_hT, g_cT, d_gates, d_h0,
                              d_c0, cs, d_h_tilde, d_c_tilde, ws, T, B, H, U, dev, stream);
}
