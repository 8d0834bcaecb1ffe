// Unmasked multi-head cross-modal attention: softmax(q·kᵀ/√d_k)·v.
//
// Replaces the TPU kernel robo_vln_tpu/ops/pallas_attention.py::_attn_kernel
// (launched by _pallas_attention), the core of VisualLingAttn's
// MultiHeadAttention: Lq = 200 instruction queries over S = 16 (rgb) or 64
// (depth) visual tokens, h = 4 heads of d_k = d_v = 64, N = B·T examples.
// Heads are addressed by stride in the (N, L, h·d) layout, so the caller needs
// no transposes.  Three routes, chosen by the dtype of q, k, v and out and,
// in float32, by shape:
//
// bfloat16 (the serving dtype).  What bounds it on the H100: bytes.  At
// N = 200 the call moves 44 MB (S = 16) or 54 MB (S = 64) and does 0.7 or
// 2.6 GFLOP, about 48 FLOP a byte at S = 64 against a bf16 ridge of about 295,
// so 13.2 and 16.1 µs at 3.35 TB/s are its least times.  What the design does
// about it: one block of 4 warps per (example, head, 64-query tile), tile
// fastest, so the tiles of one head run side by side and find its K and V in
// L2; each warp takes 16 query rows.  The block copies its Q tile and its
// head's K and V into shared memory with 16-byte cp.async (zero-filling rows
// past Lq, and past S up to a multiple of 16), in rows padded by 16 bytes so
// that ldmatrix is free of bank conflicts.  q·kᵀ runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 out; products of bf16 values are exact
// in float32, as in the TPU kernel, which upcasts to float32).  The scale, the
// -inf of padded keys and the softmax stay in float32 in the accumulator
// registers (S ≤ 128 fits whole, so no online rescaling; row max and sum by
// quad shuffles; exp2 of logits scaled by log2 e).  p·v runs on the tensor
// cores too, with the accumulator reused as the A fragment, in one of two
// modes (a template argument; the C entry's round_p).  By default p is
// rounded to bf16 once, one product against the V fragment (ldmatrix.trans),
// as the JAX package's default attention (XLA, cm_attention.py:102) rounds
// it.  Otherwise p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi),
// two products against the same V fragment, which keeps about 16 bits of
// the float32 probabilities, as its Pallas kernel keeps them
// (TPU.PALLAS_ATTENTION on); the only rounding left is then that of the
// bf16 output.  The output goes through the warp's own rows of shared memory and leaves in
// coalesced 16-byte stores.  A block does not overlap its own copies with its
// arithmetic; the several blocks on each SM do, so the register budget is set
// (min_blocks) to keep 6 blocks of 4 warps on an SM at S = 64 and 8 at S = 16.
// Takes d_k = d_v, a multiple of 16 up to 128, and S ≤ 128.
//
// bfloat16 past S = 128: key blocks (the kernel takes any S ≥ 1), for
// d_k = d_v a multiple of 16 up to 128 and pointers aligned to 16 bytes.
// Every other bf16 call up to d = 128 (d_k ≠ d_v, d off a multiple of 16,
// pointers aligned only to 2 bytes) takes its kFill instance at any S: D
// is the larger of d_k and d_v rounded up to 16, every value is copied by
// a plain load, zero past d_k and d_v, and stored one value at a time; the
// instances the aligned calls take are unchanged by it.
// Holding a head's K and V whole made shared memory grow with S (130,560
// bytes a block at S = 200, d = 128: one block an SM; nothing past S = 384
// at d = 128).  The bound is bytes (S = 144, d = 64 at N = 200: 70 MB,
// 0.021 ms at 3.35 TB/s, against 0.006 ms for its operations at 989
// TFLOP/s), but on the H100 the kernel is held by its arithmetic: with its
// global loads removed it kept 89% of its time, and mma.sync peaks at about
// 650 TFLOP/s there (scripts/attention_probe.py measures both).  Each key
// is three bf16 products (q·kᵀ, p_hi·v, p_lo·v; two with p rounded once)
// and some ten float32 instructions of softmax a logit.  What the design does about it: K and V
// stream through a ring of kBf16Stages key blocks of 16·kBf16KeyChunks
// keys, the next ones' 16-byte cp.async copies in flight while the warps
// multiply one, one barrier a key block; shared memory is a constant of D
// (36,864 bytes at d = 64, 69,632 at d = 128).  Blocks of kBf16BlockWarps
// warps on 64-row query tiles, with a register budget (kBf16MoreRegs) that
// keeps 5 blocks on an SM at d = 64 and 3 at d = 128 without spilling.
// Only the last key block has keys past S, so only its step carries the
// -inf mask and the skip of chunks wholly past S, and every other step
// runs without a branch; shared-memory addresses are a lane's base plus
// constants.  The logit scale and the max subtraction are one FMA before
// ex2.approx.  The running row max is lazy (kBf16MaxSlack): a row's
// reference moves only when a key block's max passes it by more than 2^8,
// so p <= 2^8, and the sum and the output, taken against the same
// reference, are rescaled only then; the common step needs no shuffle.  The
// products, the two modes of p and the float32 softmax in base 2 are
// otherwise the whole-key kernel's; the output is divided by the sum at the
// end (so p is rounded before it is normalised: see the kernel).
//
// float32 on the tensor cores (3xTF32), for any d_k and d_v from 1 to 256
// (d_k != d_v allowed), any S ≥ 1 and any float32 pointer; one kernel for
// S ≤ 128 with d_k and d_v up to 128, which holds the keys whole, and one
// that streams them in key blocks past S = 128, and at every S for d above
// 128 (below).  The head dimension is zero-filled in shared memory up to
// the instance's D (32, 64, 128 or 256), as the tiles are past S.  Copies
// are 16 bytes where q, k and v are aligned to 16 bytes and d_k and d_v
// are multiples of 4 (every HCM call), else one float each (4-byte
// cp.async, zero-filled alike): the width is a template parameter of both
// kernels, picked at launch.  What bounds the first: bytes,
// twice the bf16 route's (0.0587 ms for the
// window's two calls at 3.35 TB/s), while on the CUDA cores its 3.3 GFLOP
// would take almost as long (0.049 ms at 67 TFLOP/s) before any softmax or
// address arithmetic.  So both products run on mma.sync m16n8k8 tf32, each
// float32 operand split into hi = rna(x) and lo = rna(x - hi), rounded to
// tf32 explicitly (the mma reads only the top 19 bits of a register, so raw
// floats would be truncated and the split broken), and a·b = a_lo·b_hi +
// a_hi·b_lo + a_hi·b_hi, the small products first (CUTLASS's 3xTF32
// order): about 21 bits of each operand, so the result is float32-accurate;
// one tf32 product alone would move logits by about 1e-3.  The plan is the
// bf16 route's, with 8 warps a block: one block per (example, head,
// 128-query tile), tile fastest, so a head's tiles find its K and V in L2;
// each warp takes 16 query rows; the Q tile by 16-byte cp.async; the logits
// whole in the accumulators, the softmax in them by quad shuffles and exp2;
// the output through the warp's own rows of the Q tile in 16-byte stores.
// What held it back on the chip was the instructions issued, not bytes: the
// split of every K and V value in every warp, cvt.rna (which compiles to
// several instructions; two integer operations round the same), address
// arithmetic and guards.  So the block splits K and V once, its 8 warps
// sharing the work, into tiles laid out so that each fragment is one
// 64-bit load of an operand pair; sizes are compile-time (D and S rounded
// up, tiles zero-filled), so offsets are constants and loops unguarded; and
// neither product needs a shuffle: each contracts in an order that suits
// the fragments (see the kernel).  At D = 128 with S > 64 the split tiles do
// not fit in shared memory, and each warp splits the values it reads.
//
// float32 on the tensor cores past S = 128: key blocks.  Holding a head's
// K and V whole, split, makes shared memory grow with S (a block needs
// 174,080 bytes at S = 128, d = 64).  What bounds it is again bytes at d = 64 (S =
// 144 at the window's N: 0.042 ms at 3.35 TB/s against 0.036 ms for the
// three tf32 products at 495 TFLOP/s; on the CUDA cores the float32
// operations alone would take 0.088 ms), and bytes and the three products
// alike at d = 128 (S = 200: 0.098 and 0.099 ms).  What the design does
// about it: the same query tiles, warps, 3xTF32 products and split tile
// layouts as above, but S is cut into key blocks of 32 keys (KC = 4
// chunks of 8 at every D: on the card 16-key blocks were a little slower at
// S = 144 and S = 200, and 64-key blocks, one block an SM at d = 64, much
// slower), so shared memory no longer grows with S and the route takes
// any S.  Per key block the block's 8 warps split K
// and V once into the pair-load tiles; then the next key block's 16-byte
// cp.async copies go out into a raw buffer (rows of D floats, zero past S,
// d_k and d_v) and stay in flight while the warps multiply the current
// one; two barriers a key block (the copy has landed and the split tiles
// are free; the split tiles are written and the raw buffer is free).  The
// logits stay in the accumulators with an online softmax, as the bf16 key
// blocks do: the running row max rescales the row sum and the output
// accumulators after each key block, p = exp2 of logits scaled by log2 e
// goes unnormalised into p·v, keys past S are -inf in the last key block
// only, and the output is divided by the sum at the end.  One raw buffer
// and one split tile (87,552 bytes at d = 64) keep 2 blocks on an SM at D = 64,
// so one block's copies, split and barriers overlap the other's products;
// at D = 128 the Q tile alone is 69,632 bytes and a block needs 169,472: one block
// an SM, and a second split tile (to drop a barrier) does not fit.  The Q
// fragments are split again for every key block: holding them split would
// take 4·D/8 registers more a thread, or a split Q tile of twice the size.
// The whole-key kernel keeps S ≤ 128: on the H100, forced onto the window's calls (d =
// 64), the key blocks took 1.43× its time at S = 16 (half the key block
// zeros, the copy, barriers and rescale) and 0.985× at S = 64, so 1.13×
// for the window's two calls (chip_smoke.py phase 3b times both).
// At D = 256 the 128-row Q tile alone takes 135,168 bytes, so no whole-key
// instance fits and the key blocks take every S: key blocks of 8 keys (KC
// = 1), one split tile and one raw buffer, 184,704 bytes, one block of 8
// warps an SM, 128 output accumulators a thread.  (64-row tiles of 4
// warps fit 16-key blocks in 166,656 bytes: one block, 4 warps, an SM;
// slicing d_v across the grid keeps the 135,168-byte Q tile and computes
// the logits once a slice.)
//
// Wide heads, float32 with d_k or d_v above 256 and bfloat16 above 128, any
// S and alignment: cross_modal_attn_wide_kernel (its note below), on the
// tensor cores, in key blocks and slices of d_v.
//
// float32 on the CUDA cores: the first float32 kernel, which the wrapper sends no call
// since the wide kernel took its shapes; reached only when forced (route
// 0), to time it beside its successor.  Grid (example,
// head, tile of 32 queries), 8 warps a block.  The block stages K and V of
// its (example, head) in shared memory as float32 (K's rows padded by one
// float so the lanes of a warp, one key each, hit 32 different banks); where
// they do not fit, its lanes read them in place through the caches.  Each
// warp takes one query row at a time: its S logits (one key per lane), max
// and sum by warp shuffle, the softmax in registers and shared memory, then
// the d_v outputs (one dimension per lane).  It takes every shape whose q
// rows and S probabilities a warp fit in shared memory (dk + S ≤ 7264).
//
// The dynamic shared-memory limit of a kernel is raised at most once per
// device, and only for a launch that needs more than the default 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one H100 block can use
constexpr int kMaxDevices = 64;

// Raises one kernel's dynamic shared-memory limit to kMaxSmem, once per device.
struct SmemOptIn {
  std::once_flag once[kMaxDevices];
  cudaError_t status[kMaxDevices] = {};

  cudaError_t ensure(const void* kernel, size_t smem) {
    if (smem <= kDefaultSmem) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once[dev], [&] {
      status[dev] = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    });
    return status[dev];
  }
};

// ---------------------------------------------------------------- float32

constexpr int kWarps = 8;
constexpr int kQueryTile = 32;

// Shared memory of one block of cross_modal_attn_kernel<kStaged>: K (rows of
// dk + 1) and V when staged, then a q row and S probabilities a warp.
size_t f32_smem_bytes(int S, int dk, int dv, bool staged) {
  return ((staged ? (size_t)S * (dk + 1) + (size_t)S * dv : 0) +
          (size_t)kWarps * (dk + S)) * sizeof(float);
}

// kStaged: K and V of the (example, head) are copied to shared memory first;
// without it (where they do not fit) the lanes read them where they lie in
// global memory, through the caches.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
cross_modal_attn_kernel(const float* __restrict__ q,  // (N, Lq, h*dk)
                        const float* __restrict__ k,  // (N, S, h*dk)
                        const float* __restrict__ v,  // (N, S, h*dv)
                        float* __restrict__ out,      // (N, Lq, h*dv)
                        int Lq, int S, int heads, int dk, int dv, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, head = blockIdx.y, q0 = blockIdx.z * kQueryTile;
  const int Dq = heads * dk, Dv = heads * dv;
  const float* kb = k + (size_t)n * S * Dq + head * dk;
  const float* vb = v + (size_t)n * S * Dv + head * dv;
  // K's and V's rows: ldk and ldv floats apart, at k_r and v_r
  const float* k_r = kb;
  const float* v_r = vb;
  int ldk = Dq, ldv = Dv;
  float* q_s = smem;  // (kWarps, dk)
  if (kStaged) {
    float* k_s = smem;                 // (S, dk + 1)
    float* v_s = k_s + S * (dk + 1);   // (S, dv)
    for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
      const int s = idx / dk, d = idx - s * dk;
      k_s[s * (dk + 1) + d] = kb[(size_t)s * Dq + d];
    }
    for (int idx = threadIdx.x; idx < S * dv; idx += blockDim.x) {
      const int s = idx / dv, d = idx - s * dv;
      v_s[idx] = vb[(size_t)s * Dv + d];
    }
    k_r = k_s;
    v_r = v_s;
    ldk = dk + 1;
    ldv = dv;
    q_s = v_s + S * dv;
    __syncthreads();
  }
  float* p_s = q_s + kWarps * dk;  // (kWarps, S)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = q_s + warp * dk;
  float* pw = p_s + warp * S;
  for (int r = warp; r < kQueryTile; r += kWarps) {
    const int qi = q0 + r;
    if (qi >= Lq) break;  // uniform across the warp
    const float* qrow = q + ((size_t)n * Lq + qi) * Dq + head * dk;
    for (int d = lane; d < dk; d += 32) qw[d] = qrow[d];
    __syncwarp();

    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const float* kr = k_r + (size_t)s * ldk;
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

    float* orow = out + ((size_t)n * Lq + qi) * Dv + head * dv;
    for (int d = lane; d < dv; d += 32) {
      float a = 0.0f;
      for (int s = 0; s < S; ++s) a = fmaf(pw[s] * inv, v_r[(size_t)s * ldv + d], a);
      orow[d] = a;
    }
    __syncwarp();
  }
}

template <bool kStaged>
int launch_f32_as(const void* q, const void* k, const void* v, void* out, int N,
                  int Lq, int S, int heads, int dk, int dv, cudaStream_t stream) {
  static SmemOptIn opt_in;
  const size_t smem = f32_smem_bytes(S, dk, dv, kStaged);
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_kernel<kStaged>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, heads, (Lq + kQueryTile - 1) / kQueryTile);
  cross_modal_attn_kernel<kStaged><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Lq, S, heads, dk,
      dv, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

// K and V staged in shared memory wherever they fit, else read in place
int launch_f32(const void* q, const void* k, const void* v, void* out, int N,
               int Lq, int S, int heads, int dk, int dv, cudaStream_t stream) {
  if (f32_smem_bytes(S, dk, dv, true) <= (size_t)kMaxSmem)
    return launch_f32_as<true>(q, k, v, out, N, Lq, S, heads, dk, dv, stream);
  if (f32_smem_bytes(S, dk, dv, false) <= (size_t)kMaxSmem)
    return launch_f32_as<false>(q, k, v, out, N, Lq, S, heads, dk, dv, stream);
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- bfloat16

constexpr int kMmaWarps = 4;  // 16 query rows each
constexpr int kTileQ = 16 * kMmaWarps;
constexpr int kPad = 8;  // bf16 values of padding per shared-memory row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// One float (4 bytes, .ca: .cg takes only 16), zero where not valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// ldmatrix at a shared-memory address
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4(r, (uint32_t)__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_trans(r, (uint32_t)__cvta_generic_to_shared(p));
}

// c += a·b on one m16n8k16 tile: bf16 inputs, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two probabilities x and y as bf16 A-fragment words: rounded to bf16 once
// (kRoundP: hi only; lo is not set), or split p = p_hi + p_lo to about 16 bits
template <bool kRoundP>
__device__ __forceinline__ void p_pack(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  if constexpr (!kRoundP) {
    const float2 hf = __bfloat1622float2(h);
    lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
  }
}

// c += p·v on one m16n8k16 tile: p_bf16·v (kRoundP), else p_lo·v then p_hi·v
template <bool kRoundP>
__device__ __forceinline__ void p_times_v(float (&c)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  if constexpr (!kRoundP) mma_bf16(c, lo, b0, b1);
  mma_bf16(c, hi, b0, b1);
}

// A warp's 16 output rows (o_acc[t]: columns 8t..8t+7 of rows lane/4 and
// lane/4 + 8) through o_s, its own rows of the Q tile, to ob in coalesced
// 16-byte stores: rows below ``rows``
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (&o_acc)[D / 8][4],
                                                __nv_bfloat16* o_s, __nv_bfloat16* ob,
                                                int ld, int rows, int lane) {
  constexpr int P = D + kPad, kChunks = D / 8;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<__nv_bfloat162*>(o_s + g * P + 8 * t + cq) =
        __floats2bfloat162_rn(o_acc[t][0], o_acc[t][1]);
    *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8) * P + 8 * t + cq) =
        __floats2bfloat162_rn(o_acc[t][2], o_acc[t][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (r < rows)
      *reinterpret_cast<int4*>(ob + (size_t)r * ld + c) =
          *reinterpret_cast<const int4*>(o_s + r * P + c);
  }
}

// Blocks a multiprocessor should hold at once: as many as the registers
// allow once the accumulators (8·KC logits and D/2 outputs a thread) and
// about 16 registers of addresses fit, at most 8.
template <int D, int KC>
constexpr int min_blocks() {
  constexpr int regs = (8 * KC + D / 2 + 16 + 7) / 8 * 8;
  return 65536 / (kMmaWarps * 32 * regs) < 8 ? 65536 / (kMmaWarps * 32 * regs) : 8;
}

// Shared memory of one block of cross_modal_attn_bf16_kernel: the 64-row Q
// tile, K and V (S rounded up to 16), in rows of D + kPad values.
__host__ __device__ constexpr size_t bf16_smem_bytes(int D, int S) {
  return sizeof(__nv_bfloat16) * (D + kPad) * (kTileQ + 2 * ((S + 15) & ~15));
}

// S ≤ 128.  D: d_k = d_v; KC: S rounded up to 16, over 16 (1, 2, 4 or 8);
// kRoundP: p rounded to bf16 once before p·v (see cross_modal_attn below),
// else split into p_hi + p_lo.  One block per (example, head, 64-query
// tile), tile fastest.  The Q tile and the head's K and V (S rounded up to
// 16 with zero rows) go to shared memory; each warp takes 16 query rows,
// normalises its probabilities before p·v (so the rounding falls where
// XLA's does: on the normalised p), and its output goes back through its
// own rows of the Q tile to leave in 16-byte stores.
template <int D, int KC, bool kRoundP>
__global__ void __launch_bounds__(kMmaWarps * 32, min_blocks<D, KC>())
cross_modal_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ out, int Lq, int S,
                             int heads, int tiles, float scale) {
  constexpr int P = D + kPad;  // row pitch of the shared tiles, in values
  constexpr int kChunks = D / 8;  // 16-byte chunks in one head's row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = (S + 15) & ~15;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (64, P)
  __nv_bfloat16* k_s = q_s + kTileQ * P;                            // (s_pad, P)
  __nv_bfloat16* v_s = k_s + s_pad * P;                             // (s_pad, P)

  const int b = blockIdx.x;
  const int nh = b / tiles;  // n * heads + head
  const int q0 = (b - nh * tiles) * kTileQ;
  const int n = nh / heads, head = nh - n * heads;
  const int ld = heads * D;  // row stride of q, k, v and out
  const __nv_bfloat16* qb = q + ((size_t)n * Lq + q0) * ld + head * D;
  const size_t kv = (size_t)n * S * ld + head * D;
  for (int i = threadIdx.x; i < kTileQ * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = q0 + r < Lq;
    cp_async16(q_s + r * P + c, ok ? qb + (size_t)r * ld + c : q, ok);
  }
  for (int i = threadIdx.x; i < s_pad * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < S;
    cp_async16(k_s + r * P + c, ok ? k + kv + (size_t)r * ld + c : k, ok);
    cp_async16(v_s + r * P + c, ok ? v + kv + (size_t)r * ld + c : v, ok);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // each warp takes 16 query rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int rows = min(kTileQ, Lq - q0);
  if (row0 >= rows) return;  // no valid rows for this warp; no barrier follows
  const int chunks = s_pad / 16;
  const float scale2 = scale * 1.4426950408889634f;

  // logits: n-tile t holds keys 8t..8t+7; [0], [1] row lane/4, [2], [3] row
  // lane/4 + 8, keys 8t + 2(lane%4) + {0, 1}
  float s_acc[2 * KC][4];
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[t][e] = 0.0f;
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, q_s + (row0 + (lane & 15)) * P + kd + (lane >> 4) * 8);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c < chunks) {
        uint32_t bk[4];  // b0, b1 of keys 16c..+7, then of the next 8
        ldmatrix_x4(bk, k_s + (16 * c + (lane & 7) + ((lane >> 4) << 3)) * P + kd +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s_acc[2 * c], a, bk[0], bk[1]);
        mma_bf16(s_acc[2 * c + 1], a, bk[2], bk[3]);
      }
    }
  }

  // softmax over each row in float32, in base 2 (exp2 of logits·log2 e);
  // a row lives in the 4 lanes of a quad
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[t][e] *= scale2;
  if (S < 16 * KC) {  // keys past S (and past the last chunk): -inf
#pragma unroll
    for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * t + 2 * (lane & 3) + (e & 1) >= S) s_acc[t][e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[t][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s_acc[t][e] - mx[e >> 1]);
      s_acc[t][e] = p;
      sum[e >> 1] += p;
    }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    inv[h] = 1.0f / sum[h];
  }

  // out = p·v, p normalised before it is rounded (p_bf16) or split (p_hi
  // + p_lo); n-tile t of o_acc holds columns 8t..8t+7
  float o_acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[t][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < chunks) {
      // the A fragment of keys 16c..+15 is n-tiles 2c and 2c + 1
      uint32_t hi[4], lo[4];
      p_pack<kRoundP>(s_acc[2 * c][0] * inv[0], s_acc[2 * c][1] * inv[0], hi[0], lo[0]);
      p_pack<kRoundP>(s_acc[2 * c][2] * inv[1], s_acc[2 * c][3] * inv[1], hi[1], lo[1]);
      p_pack<kRoundP>(s_acc[2 * c + 1][0] * inv[0], s_acc[2 * c + 1][1] * inv[0], hi[2], lo[2]);
      p_pack<kRoundP>(s_acc[2 * c + 1][2] * inv[1], s_acc[2 * c + 1][3] * inv[1], hi[3], lo[3]);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t bv[4];  // b0, b1 of columns 16dt..+7, then of 16dt+8..+15
        ldmatrix_x4_trans(bv, v_s + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  16 * dt + (lane >> 4) * 8);
        p_times_v<kRoundP>(o_acc[2 * dt], hi, lo, bv[0], bv[1]);
        p_times_v<kRoundP>(o_acc[2 * dt + 1], hi, lo, bv[2], bv[3]);
      }
    }
  }
  store_rows_bf16<D>(o_acc, q_s + row0 * P, out + ((size_t)n * Lq + q0 + row0) * ld + head * D,
                     ld, rows - row0, lane);
}

template <int D, int KC, bool kRoundP>
int launch_bf16_tiles(const void* q, const void* k, const void* v, void* out,
                      int N, int Lq, int S, int heads, cudaStream_t stream) {
  static SmemOptIn opt_in;
  const size_t smem = bf16_smem_bytes(D, S);
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_bf16_kernel<D, KC, kRoundP>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kTileQ - 1) / kTileQ;
  const long long blocks = (long long)N * heads * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_bf16_kernel<D, KC, kRoundP>
      <<<(unsigned)blocks, kMmaWarps * 32, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
          Lq, S, heads, tiles, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bfloat16 in key blocks

constexpr int kBf16BlockWarps = 4;  // 16 query rows each: 64-row query tiles
constexpr int kBf16KeyChunks = 2;   // 16-key chunks of one key block: 32 keys
constexpr int kBf16Stages = 3;      // key blocks in the ring
constexpr int kBf16MoreRegs = 48;   // registers a thread beyond the accumulators
constexpr int kBf16FillRegs = 32;   // the same, more, for kFill's copies
constexpr float kBf16MaxSlack = 8.0f;  // log2 of the largest p before a rescale

// Shared memory of one block of cross_modal_attn_bf16_blocks_kernel<D>: the
// Q tile (16 rows a warp) and the ring's stages, each the K and V of one
// key block of 16·kBf16KeyChunks keys, all in rows of D + kPad values,
// whatever S.
__host__ __device__ constexpr size_t bf16_blocks_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) * (D + kPad) *
         (16 * kBf16BlockWarps + 2 * kBf16Stages * 16 * kBf16KeyChunks);
}

// Blocks a multiprocessor should hold at once: as many as the registers
// allow once the accumulators (8·kBf16KeyChunks logits and D/2 outputs a
// thread) and kBf16MoreRegs registers of fragments, addresses and the
// softmax's state fit (with kFill, kBf16FillRegs more for the limits and
// strides of its copies), and as many as the shared memory holds, at most 8.
constexpr int bf16_blocks_an_sm(int D, bool kFill = false) {
  const int regs =
      (8 * kBf16KeyChunks + D / 2 + kBf16MoreRegs + (kFill ? kBf16FillRegs : 0) + 7) / 8 * 8;
  const int by_regs = 65536 / (kBf16BlockWarps * 32 * regs);
  const int by_smem = 233472 / (int)(bf16_blocks_smem_bytes(D) + 1024);
  const int m = by_regs < by_smem ? by_regs : by_smem;
  return m < 1 ? 1 : (m > 8 ? 8 : m);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's newest commit groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// 2^x in one instruction (the approximation exp2f rests on, with results
// below 2^-126 flushed to 0: a probability that small adds nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One bf16 value where no 16-byte copy can start: a plain load (zero where
// not valid)
__device__ __forceinline__ __nv_bfloat16 ldg_bf16(const __nv_bfloat16* src, bool ok) {
  return ok ? __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(src)))
            : __ushort_as_bfloat16((unsigned short)0);
}

// S > 128, or (kFill) any other bf16 call up to d = 128: the keys streamed
// through a ring of kStages key blocks of 16·KC keys (the kBf16 constants
// above).  D: d_k = d_v, or with kFill max(d_k, d_v) rounded up to 16.
// kFill takes any d_k and d_v and pointers aligned only to 2 bytes: every
// value is copied by a plain load, zero past d_k (Q, K) and d_v (V), so the
// columns past d_k add nothing to q·kᵀ and those past d_v give outputs that
// are not stored, and the output leaves one value a store (the loads land
// before the thread's own stores to shared memory, so the ring's commit
// groups are empty and its barriers do the rest); the instances without it
// are the aligned d_k = d_v kernel as it was, so the calls that take them
// (every HCM call) run the same code.  kWarps warps a block,
// 16 query rows each.  One block per (example, head, 16·kWarps-query tile),
// tile fastest, so the tiles of one head run side by side and find its K
// and V in L2.  The Q tile and the first kStages - 1 key blocks go out as
// 16-byte cp.async copies, one commit group each; each key block then
// takes one barrier, after which the block issues the copy of key block
// blk + kStages - 1 into the stage that key block blk - 1 used, and the
// warps multiply key block blk while the copies of the next ones are in
// flight.  Keys past S are zero rows (the copy's source size 0) and -inf
// logits; only the last key block has them, and only its step carries the
// mask and skips the 16-key chunks wholly past S, so every other step runs
// without a branch.  The softmax is online, in float32 and base 2, against
// a lazy reference max per row (of logits scaled by log2 e / √d; see the
// step): p = 2^(logit·scale - max) (one FMA) goes unnormalised into p·v,
// split into p_hi·v + p_lo·v or, with kRoundP, rounded to bf16 once, and
// the output is divided by the sum (of the float32 p) at the end.  So with
// kRoundP the rounding falls on p against the lazy reference, not on the
// normalised p that XLA rounds: bf16 rounding is relative, so the two
// roundings each move a key's term by at most 2^-9 of it, and the outputs
// differ by at most 2^-8 max|v| before the output's own rounding.  Every
// warp copies and meets the barriers, including a warp with no query rows
// in a partial tile, which multiplies nothing.
template <int D, bool kRoundP, bool kFill>
__global__ void __launch_bounds__(kBf16BlockWarps * 32, bf16_blocks_an_sm(D, kFill))
cross_modal_attn_bf16_blocks_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    __nv_bfloat16* __restrict__ out, int Lq, int S,
                                    int heads, int dk, int dv, int tiles, float scale) {
  constexpr int KC = kBf16KeyChunks, kWarps = kBf16BlockWarps, kStages = kBf16Stages;
  constexpr int P = D + kPad;         // row pitch of the shared tiles, in values
  constexpr int kChunks = D / 8;      // 16-byte chunks in one head's row
  constexpr int kTile = 16 * kWarps;  // query rows of a block
  constexpr int kKeys = 16 * KC;      // keys of a key block
  constexpr int kThreads = kWarps * 32;
  constexpr int kItems = kKeys * kChunks;  // 16-byte copies of K (and of V) a key block
  constexpr int kStageBytes = 2 * kKeys * P * 2;
  static_assert(kTile * kChunks % kThreads == 0, "whole rounds of 16-byte copies");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kTile, P)
  __nv_bfloat16* ring = q_s + kTile * P;  // kStages × (K (kKeys, P), V (kKeys, P))

  const int b = blockIdx.x;
  const int nh = b / tiles;  // n * heads + head
  const int q0 = (b - nh * tiles) * kTile;
  const int n = nh / heads, head = nh - n * heads;
  const int ld = heads * D;  // row stride of q, k, v and out (kFill: of none)
  const __nv_bfloat16* qb = q + ((size_t)n * Lq + q0) * (kFill ? heads * dk : ld) +
                            head * (kFill ? dk : D);
  const __nv_bfloat16* kb = k + (size_t)n * S * (kFill ? heads * dk : ld) + head * (kFill ? dk : D);
  const __nv_bfloat16* vb = v + (size_t)n * S * (kFill ? heads * dv : ld) + head * (kFill ? dv : D);
  if constexpr (kFill) {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D;
      q_s[r * P + c] = ldg_bf16(qb + (size_t)r * heads * dk + c, q0 + r < Lq && c < dk);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = q0 + r < Lq;
      cp_async16(q_s + r * P + c, ok ? qb + (size_t)r * ld + c : q, ok);
    }
  }
  // key block blk into its stage of the ring, zero past S (kFill: and past
  // d_k and d_v)
  auto copy_block = [&](int blk) {
    __nv_bfloat16* k_s = ring + (blk % kStages) * 2 * kKeys * P;
    __nv_bfloat16* v_s = k_s + kKeys * P;
    const int s0 = blk * kKeys;
    if constexpr (kFill) {
      for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool ok = s0 + r < S;
        k_s[r * P + c] = ldg_bf16(kb + (size_t)(s0 + r) * heads * dk + c, ok && c < dk);
        v_s[r * P + c] = ldg_bf16(vb + (size_t)(s0 + r) * heads * dv + c, ok && c < dv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < (kItems + kThreads - 1) / kThreads; ++j) {
        const int i = j * kThreads + threadIdx.x;
        if (kItems % kThreads == 0 || i < kItems) {
          const int r = i / kChunks, c = (i % kChunks) * 8;
          const bool ok = s0 + r < S;
          const size_t at = (size_t)(s0 + r) * ld + c;
          cp_async16(k_s + r * P + c, ok ? kb + at : kb, ok);
          cp_async16(v_s + r * P + c, ok ? vb + at : vb, ok);
        }
      }
    }
  };
  const int n_blocks = (S + kKeys - 1) / kKeys;
#pragma unroll
  for (int blk = 0; blk < kStages - 1; ++blk) {  // the Q tile goes with key block 0
    if (blk < n_blocks) copy_block(blk);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int rows = min(kTile, Lq - q0);
  const bool has_rows = row0 < rows;
  const float scale2 = scale * 1.4426950408889634f;
  // shared-memory addresses of the lane's ldmatrix rows: its A rows of the
  // Q tile; its B rows of K (keys (lane & 7) + 8(lane >> 4), dims 8((lane
  // >> 3) & 1) on); its B rows of V, transposed (keys (lane & 7) + 8((lane
  // >> 3) & 1), columns 8(lane >> 4) on).  Every other offset is a constant.
  const uint32_t q_lane = (uint32_t)__cvta_generic_to_shared(q_s) +
                          2 * ((row0 + (lane & 15)) * P + (lane >> 4) * 8);
  const uint32_t k_lane = (uint32_t)__cvta_generic_to_shared(ring) +
                          2 * (((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = (uint32_t)__cvta_generic_to_shared(ring) + 2 * kKeys * P +
                          2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
  // out = p·v; n-tile t of o_acc holds columns 8t..8t+7
  float o_acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[t][e] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY};  // running row max (scaled, base 2)
  float sum[2] = {0.0f, 0.0f};           // the lane's share of the row sum

  // one key block in ring stage ``stage``; only the last key block (last:
  // std::true_type) has keys past S, from ``valid`` on
  auto step = [&](auto last, int stage, int valid) {
    constexpr bool kLast = decltype(last)::value;
    const uint32_t k_at = k_lane + stage * kStageBytes;
    const uint32_t v_at = v_lane + stage * kStageBytes;
    // logits: n-tile t holds the key block's keys 8t..8t+7; [0], [1] row
    // lane/4, [2], [3] row lane/4 + 8, keys 8t + 2(lane%4) + {0, 1}
    float s_acc[2 * KC][4];
#pragma unroll
    for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[t][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, q_lane + 2 * kd);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (!kLast || 16 * c < valid) {  // a chunk wholly past S adds nothing
          uint32_t bk[4];  // b0, b1 of keys 16c..+7, then of the next 8
          ldmatrix_x4(bk, k_at + 2 * (16 * c * P + kd));
          mma_bf16(s_acc[2 * c], a, bk[0], bk[1]);
          mma_bf16(s_acc[2 * c + 1], a, bk[2], bk[3]);
        }
      }
    }

    // online softmax in float32, base 2; a row lives in the 4 lanes of a quad
    if constexpr (kLast) {  // keys past S are -inf
#pragma unroll
      for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * t + 2 * (lane & 3) + (e & 1) >= valid) s_acc[t][e] = -INFINITY;
    }
    // A row's reference max moves only when the key block's max passes it
    // by more than kBf16MaxSlack (always at the first key block), so p <=
    // 2^kBf16MaxSlack, and the sum and the output, both taken against the
    // same reference, need no rescaling otherwise.  Each lane tests its
    // own logits; only when a row of the warp moves does the warp reduce
    // the rows' max across the quads' lanes and rescale.
    float bm[2] = {-INFINITY, -INFINITY};  // the lane's max of each of its rows
#pragma unroll
    for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s_acc[t][e]);
    // the scale is positive, so the max of scaled logits is the scaled max
    const bool raise = bm[0] * scale2 > mx[0] + kBf16MaxSlack ||
                       bm[1] * scale2 > mx[1] + kBf16MaxSlack;
    if (__any_sync(0xffffffffu, raise)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
        bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
        bm[h] *= scale2;  // finite: every key block holds a key below S
        const float m = bm[h] > mx[h] + kBf16MaxSlack ? bm[h] : mx[h];
        const float alpha = ex2(mx[h] - m);  // 0 at the first key block, 1 for a row that stays
        sum[h] *= alpha;
#pragma unroll
        for (int t = 0; t < D / 8; ++t) {
          o_acc[t][2 * h] *= alpha;
          o_acc[t][2 * h + 1] *= alpha;
        }
        mx[h] = m;
      }
    }
#pragma unroll
    for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_acc[t][e] = ex2(fmaf(s_acc[t][e], scale2, -mx[e >> 1]));
        sum[e >> 1] += s_acc[t][e];
      }

#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (!kLast || 16 * c < valid) {
        // the A fragment of keys 16c..+15 is n-tiles 2c and 2c + 1, p as it is
        uint32_t hi[4], lo[4];
        p_pack<kRoundP>(s_acc[2 * c][0], s_acc[2 * c][1], hi[0], lo[0]);
        p_pack<kRoundP>(s_acc[2 * c][2], s_acc[2 * c][3], hi[1], lo[1]);
        p_pack<kRoundP>(s_acc[2 * c + 1][0], s_acc[2 * c + 1][1], hi[2], lo[2]);
        p_pack<kRoundP>(s_acc[2 * c + 1][2], s_acc[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          uint32_t bv[4];  // b0, b1 of columns 16dt..+7, then of 16dt+8..+15
          ldmatrix_x4_trans(bv, v_at + 2 * (16 * c * P + 16 * dt));
          p_times_v<kRoundP>(o_acc[2 * dt], hi, lo, bv[0], bv[1]);
          p_times_v<kRoundP>(o_acc[2 * dt + 1], hi, lo, bv[2], bv[3]);
        }
      }
    }
  };

  for (int blk = 0; blk < n_blocks; ++blk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of key block blk have landed
    __syncthreads();  // every thread's have; no warp reads the stage refilled next
    if (blk + kStages - 1 < n_blocks) copy_block(blk + kStages - 1);
    cp_async_commit();  // empty past the last key block, to keep the count
    if (!has_rows) continue;
    if (blk + 1 < n_blocks)
      step(std::false_type{}, blk % kStages, kKeys);
    else
      step(std::true_type{}, blk % kStages, S - blk * kKeys);
  }
  if (!has_rows) return;  // no barrier follows

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const float inv = 1.0f / sum[h];
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o_acc[t][2 * h] *= inv;
      o_acc[t][2 * h + 1] *= inv;
    }
  }
  if constexpr (kFill) {  // rows g, g + 8 of the warp, columns below d_v, one value a store
    __nv_bfloat16* ob = out + ((size_t)n * Lq + q0 + row0) * heads * dv + head * dv;
    const int g = lane >> 2, cq = 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), c = 8 * t + cq + (e & 1);
        if (r < rows - row0 && c < dv)
          ob[(size_t)r * heads * dv + c] = __float2bfloat16_rn(o_acc[t][e]);
      }
  } else {
    store_rows_bf16<D>(o_acc, q_s + row0 * P,
                       out + ((size_t)n * Lq + q0 + row0) * ld + head * D, ld, rows - row0,
                       lane);
  }
}

template <int D, bool kRoundP, bool kFill>
int launch_bf16_blocks(const void* q, const void* k, const void* v, void* out, int N,
                       int Lq, int S, int heads, int dk, int dv, cudaStream_t stream) {
  static SmemOptIn opt_in;
  constexpr size_t smem = bf16_blocks_smem_bytes(D);
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  const cudaError_t err = opt_in.ensure(
      (const void*)cross_modal_attn_bf16_blocks_kernel<D, kRoundP, kFill>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kTile = 16 * kBf16BlockWarps;
  const int tiles = (Lq + kTile - 1) / kTile;
  const long long blocks = (long long)N * heads * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_bf16_blocks_kernel<D, kRoundP, kFill>
      <<<(unsigned)blocks, kBf16BlockWarps * 32, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
          Lq, S, heads, dk, dv, tiles, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

// The keys whole (S <= 128) or, where key_blocks, streamed in key blocks
// (any S); fill (d_k != d_v, d off a multiple of 16, pointers off 16
// bytes): the key blocks' kFill instance at D = max(d_k, d_v) rounded up
// to 16, any S.
template <int D, bool kRoundP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int N, int Lq,
                int S, int heads, int dk, int dv, bool key_blocks, bool fill,
                cudaStream_t s) {
  if (fill)
    return launch_bf16_blocks<D, kRoundP, true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (key_blocks)
    return launch_bf16_blocks<D, kRoundP, false>(q, k, v, out, N, Lq, S, heads, D, D, s);
  if (S <= 16) return launch_bf16_tiles<D, 1, kRoundP>(q, k, v, out, N, Lq, S, heads, s);
  if (S <= 32) return launch_bf16_tiles<D, 2, kRoundP>(q, k, v, out, N, Lq, S, heads, s);
  if (S <= 64) return launch_bf16_tiles<D, 4, kRoundP>(q, k, v, out, N, Lq, S, heads, s);
  if (S <= 128) return launch_bf16_tiles<D, 8, kRoundP>(q, k, v, out, N, Lq, S, heads, s);
  return (int)cudaErrorInvalidValue;
}

// D: max(d_k, d_v) rounded up to 16 (d_k = d_v = D unless fill)
template <bool kRoundP>
int launch_bf16_mode(const void* q, const void* k, const void* v, void* out, int N, int Lq,
                     int S, int heads, int dk, int dv, bool key_blocks, bool fill,
                     cudaStream_t s) {
#define BF16_D(d)                                                                          \
  case d:                                                                                   \
    return launch_bf16<d, kRoundP>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, fill, s);
  switch ((((dk > dv ? dk : dv) + 15) / 16) * 16) {
    BF16_D(16)
    BF16_D(32)
    BF16_D(48)
    BF16_D(64)
    BF16_D(80)
    BF16_D(96)
    BF16_D(112)
    BF16_D(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BF16_D
}

int launch_bf16_any(const void* q, const void* k, const void* v, void* out, int N, int Lq,
                    int S, int heads, int dk, int dv, bool key_blocks, bool fill, bool round_p,
                    cudaStream_t s) {
  if (round_p)
    return launch_bf16_mode<true>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, fill, s);
  return launch_bf16_mode<false>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, fill, s);
}

// ------------------------------------------- float32 on the tensor cores

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite value (10 mantissa
// bits, to nearest, ties away from zero: the sign-magnitude bits round up
// in magnitude), in the 32-bit register the tf32 mma reads.  Two integer
// operations; cvt.rna itself compiles to several more.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 21 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a·b on one m16n8k8 tile: tf32 inputs, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32: a_lo·b_hi and a_hi·b_lo first, then a_hi·b_hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

constexpr int kF32Warps = 8;  // 16 query rows each
constexpr int kF32Tile = 16 * kF32Warps;

// Four values of one key's row into its row of split K: hi at row[0..3],
// lo at row[D..D+3]
__device__ __forceinline__ void split_key4(float* row, int D, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(row) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(row + D) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Four columns of two keys 2j and 2j + 1 (x0, x1) into the row of split V
// that pairs them: (hi, hi) pairs at row[0..7], (lo, lo) at row[2D..2D+7]
__device__ __forceinline__ void split_key_pair4(float* row, int D, float4 x0, float4 x1) {
  uint32_t h[8], l[8];
  split_tf32(x0.x, h[0], l[0]);
  split_tf32(x1.x, h[1], l[1]);
  split_tf32(x0.y, h[2], l[2]);
  split_tf32(x1.y, h[3], l[3]);
  split_tf32(x0.z, h[4], l[4]);
  split_tf32(x1.z, h[5], l[5]);
  split_tf32(x0.w, h[6], l[6]);
  split_tf32(x1.w, h[7], l[7]);
  *reinterpret_cast<uint4*>(row) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(row + 4) = make_uint4(h[4], h[5], h[6], h[7]);
  *reinterpret_cast<uint4*>(row + 2 * D) = make_uint4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<uint4*>(row + 2 * D + 4) = make_uint4(l[4], l[5], l[6], l[7]);
}

// The copy width of the float32 tensor-core kernels (kNarrow below): 16
// bytes, four floats a copy, where q, k and v are aligned to 16 bytes and
// d_k and d_v are multiples of 4, so that every head's row starts on a
// 16-byte boundary and no four floats from a column below d straddle d;
// else one float a copy (any 4-byte-aligned pointer, any d).  Both fill
// zeros past the row's ``left`` columns (d minus the first column) and
// where the row itself is invalid.

// Four floats at src (columns c..c+3 of a row) into dst in shared memory
template <bool kNarrow>
__device__ __forceinline__ void cp_async_f4(float* dst, const float* src, const float* any,
                                            bool row_ok, int left) {
  if constexpr (kNarrow) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row_ok && e < left;
      cp_async4(dst + e, ok ? src + e : any, ok);
    }
  } else {
    const bool ok = row_ok && left > 0;
    cp_async16(dst, ok ? src : any, ok);
  }
}

// The same four floats into registers, through the read-only cache
template <bool kNarrow>
__device__ __forceinline__ float4 ldg_f4(const float* src, bool row_ok, int left) {
  if constexpr (kNarrow) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = row_ok && e < left ? __ldg(src + e) : 0.0f;
    return make_float4(x[0], x[1], x[2], x[3]);
  } else {
    return row_ok && left > 0 ? __ldg(reinterpret_cast<const float4*>(src))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A warp's 16 output rows (o_acc[dt]: columns 8dt..8dt+7 of rows g and
// g + 8) through o_s, its own rows of the Q tile (pitch P), to ob: rows
// below ``rows``, columns below dv, in 16-byte stores (kNarrow: one float
// a store)
template <int D, bool kNarrow>
__device__ __forceinline__ void store_rows(const float (&o_acc)[D / 8][4], float* o_s, int P,
                                           float* ob, int ldv, int rows, int dv, int lane) {
  constexpr int kChunks = D / 4;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<float2*>(o_s + g * P + 8 * dt + 2 * t) =
        make_float2(o_acc[dt][0], o_acc[dt][1]);
    *reinterpret_cast<float2*>(o_s + (g + 8) * P + 8 * dt + 2 * t) =
        make_float2(o_acc[dt][2], o_acc[dt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = j * 32 + lane;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    if (r >= rows || c >= dv) continue;
    if constexpr (kNarrow) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < dv) ob[(size_t)r * ldv + c + e] = o_s[r * P + c + e];
    } else {
      *reinterpret_cast<float4*>(ob + (size_t)r * ldv + c) =
          *reinterpret_cast<const float4*>(o_s + r * P + c);
    }
  }
}

// Shared memory of one block of cross_modal_attn_f32tc_kernel<D, KC>: the
// 128-row Q tile in rows of D + 8 floats, then K and V (8·KC keys) either
// split once for the block (split) or as they are (raw).  Split: K's rows
// as D hi then D lo values (2D + 8), V's pairs of rows (2j, 2j+1) as D
// (hi, hi) pairs then D (lo, lo) pairs (4D + 8).  Raw: K in rows of D + 8,
// V in rows of D + 4.
__host__ __device__ constexpr size_t f32tc_smem_bytes(int D, int KC, bool split) {
  return sizeof(float) *
         ((size_t)kF32Tile * (D + 8) +
          (split ? (size_t)8 * KC * (2 * D + 8) + (size_t)4 * KC * (4 * D + 8)
                 : (size_t)8 * KC * (2 * D + 12)));
}

// K and V are split once for the block wherever the split tiles fit in
// shared memory: every instance but D = 128 with S > 64, where each warp
// splits the values it reads.
__host__ __device__ constexpr bool f32tc_split_once(int D, int KC) {
  return f32tc_smem_bytes(D, KC, true) <= (size_t)kMaxSmem;
}

// Blocks a multiprocessor should hold at once: as many as the registers
// allow once the accumulators (4·KC logits and D/2 outputs a thread) and
// ``more`` registers of fragments and addresses fit, and as many as the
// shared memory (smem bytes a block) holds, at most 8.
constexpr int f32tc_blocks_an_sm(int D, int KC, int more, size_t smem) {
  const int regs = (4 * KC + D / 2 + more + 7) / 8 * 8;
  const int by_regs = 65536 / (kF32Warps * 32 * regs);
  const int by_smem = 233472 / (int)(smem + 1024);
  const int m = by_regs < by_smem ? by_regs : by_smem;
  return m < 1 ? 1 : (m > 8 ? 8 : m);
}

template <int D, int KC>
constexpr int f32tc_min_blocks() {
  return f32tc_blocks_an_sm(D, KC, 40, f32tc_smem_bytes(D, KC, f32tc_split_once(D, KC)));
}

// D: d_k and d_v rounded up to 32, 64 or 128; KC: S rounded up to 16, 32,
// 64 or 128, over 8 (8-key chunks); kNarrow: the copy width (one float, or
// four; see cp_async_f4).  The tiles are zero past Lq, S, d_k and d_v up
// to these sizes, so every loop runs to a compile-time count, every
// shared-memory offset is a constant, and the zeros add nothing: a head
// dimension off a multiple of 8 is zero-filled to D like the rest.  One
// block of 8 warps per (example, head, 128-query tile), tile fastest; each
// warp takes 16 query rows.  Where K and V are split once for the block,
// the 8 warps share that work, and every fragment of K and V is a 64-bit
// load of an operand pair; the Q fragments are split by the warp that owns
// them.
template <int D, int KC, bool kNarrow>
__global__ void __launch_bounds__(kF32Warps * 32, f32tc_min_blocks<D, KC>())
cross_modal_attn_f32tc_kernel(const float* __restrict__ q,  // (N, Lq, h*dk)
                              const float* __restrict__ k,  // (N, S, h*dk)
                              const float* __restrict__ v,  // (N, S, h*dv)
                              float* __restrict__ out,      // (N, Lq, h*dv)
                              int Lq, int S, int heads, int dk, int dv, int tiles,
                              float scale) {
  constexpr bool kSplit = f32tc_split_once(D, KC);
  // row pitches in floats: P, and PK and PV of split tiles, ≡ 8 (mod 32),
  // so that a quad-row fragment's 64-bit loads (8 rows × 4 pairs, or 4 row
  // pairs × 8 columns) fall in 32 different banks in each half warp; raw
  // V's PV ≡ 4 (mod 8), for its 32-bit loads of 4 row pairs × 8 columns
  constexpr int P = D + 8;
  constexpr int PK = kSplit ? 2 * D + 8 : D + 8;
  constexpr int PV = kSplit ? 4 * D + 8 : D + 4;
  constexpr int kRows = 8 * KC;
  constexpr int kChunks = D / 4;  // 16-byte chunks in one row of a tile
  constexpr int kThreads = kF32Warps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (128, P)
  float* k_s = q_s + kF32Tile * P;                   // (kRows, PK)
  float* v_s = k_s + kRows * PK;                     // (kRows / 2, PV) split, (kRows, PV) raw

  const int b = blockIdx.x;
  const int nh = b / tiles;  // n * heads + head
  const int q0 = (b - nh * tiles) * kF32Tile;
  const int n = nh / heads, head = nh - n * heads;
  const int ldk = heads * dk, ldv = heads * dv;  // row strides
  const float* qb = q + ((size_t)n * Lq + q0) * ldk + head * dk;
  const float* kb = k + (size_t)n * S * ldk + head * dk;
  const float* vb = v + (size_t)n * S * ldv + head * dv;
#pragma unroll
  for (int j = 0; j < kF32Tile * kChunks / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    cp_async_f4<kNarrow>(q_s + r * P + c, qb + (size_t)r * ldk + c, q, q0 + r < Lq, dk - c);
  }
  if constexpr (kSplit) {
    // items: 4 dims of one key (K), 4 columns of a pair of keys (V); every
    // load is issued before the first split
    constexpr int kKItems = kRows * kChunks, kVItems = kRows / 2 * kChunks;
    constexpr int kKPer = (kKItems + kThreads - 1) / kThreads;
    constexpr int kVPer = (kVItems + kThreads - 1) / kThreads;
    float4 kx[kKPer], vx[kVPer][2];
#pragma unroll
    for (int j = 0; j < kKPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int r = i / kChunks, c = (i % kChunks) * 4;
      kx[j] = ldg_f4<kNarrow>(kb + (size_t)r * ldk + c, i < kKItems && r < S, dk - c);
    }
#pragma unroll
    for (int j = 0; j < kVPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int r = 2 * (i / kChunks), c = (i % kChunks) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        vx[j][h] = ldg_f4<kNarrow>(vb + (size_t)(r + h) * ldv + c, i < kVItems && r + h < S,
                                   dv - c);
    }
#pragma unroll
    for (int j = 0; j < kKPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (i < kKItems) {
        const int r = i / kChunks, c = (i % kChunks) * 4;
        split_key4(k_s + r * PK + c, D, kx[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kVPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (i < kVItems) {
        const int rp = i / kChunks, c = (i % kChunks) * 4;
        split_key_pair4(v_s + rp * PV + 2 * c, D, vx[j][0], vx[j][1]);
      }
    }
  } else {
    static_assert(kRows * kChunks % kThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
    for (int j = 0; j < kRows * kChunks / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int r = i / kChunks, c = (i % kChunks) * 4;
      cp_async_f4<kNarrow>(k_s + r * PK + c, kb + (size_t)r * ldk + c, k, r < S, dk - c);
      cp_async_f4<kNarrow>(v_s + r * PV + c, vb + (size_t)r * ldv + c, v, r < S, dv - c);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int rows = min(kF32Tile, Lq - q0);
  if (row0 >= rows) return;  // no valid rows for this warp; no barrier follows
  const int g = lane >> 2, t = lane & 3;

  // logits: s_acc[c] holds keys 8c..8c+7: [0], [1] row g, [2], [3] row g + 8,
  // keys 8c + 2t + {0, 1}.  q·kᵀ runs over groups of 8 dims, each contracted
  // in another order: the mma's k-index j < 4 stands for dim 8kt + 2j and
  // j + 4 for dim 8kt + 2j + 1, so that A's k-indices (t, t+4) and B's are
  // adjacent floats, one 64-bit load each.  A: rows g and g+8 at dims 2t,
  // 2t+1; B: key g.
  float s_acc[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[c][e] = 0.0f;
  const float* qa = q_s + (row0 + g) * P + 2 * t;
  const float* kr = k_s + g * PK + 2 * t;
#pragma unroll
  for (int kt = 0; kt < D / 8; ++kt) {
    const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kt);
    const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * P + 8 * kt);
    uint32_t a_hi[4], a_lo[4];
    split_tf32(x0.x, a_hi[0], a_lo[0]);
    split_tf32(x1.x, a_hi[1], a_lo[1]);
    split_tf32(x0.y, a_hi[2], a_lo[2]);
    split_tf32(x1.y, a_hi[3], a_lo[3]);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t b_hi[2], b_lo[2];
      if constexpr (kSplit) {
        const uint2 h = *reinterpret_cast<const uint2*>(kr + 8 * c * PK + 8 * kt);
        const uint2 l = *reinterpret_cast<const uint2*>(kr + 8 * c * PK + D + 8 * kt);
        b_hi[0] = h.x;
        b_hi[1] = h.y;
        b_lo[0] = l.x;
        b_lo[1] = l.y;
      } else {
        const float2 y = *reinterpret_cast<const float2*>(kr + 8 * c * PK + 8 * kt);
        split_tf32(y.x, b_hi[0], b_lo[0]);
        split_tf32(y.y, b_hi[1], b_lo[1]);
      }
      mma_3xtf32(s_acc[c], a_hi, a_lo, b_hi, b_lo);
    }
  }

  // softmax over each row in float32, in base 2 (exp2 of logits·log2 e);
  // a row lives in the 4 lanes of a quad
  const float scale2 = scale * 1.4426950408889634f;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // keys past S (zero rows of K): -inf
      s_acc[c][e] = 8 * c + 2 * t + (e & 1) < S ? s_acc[c][e] * scale2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[c][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s_acc[c][e] - mx[e >> 1]);
      s_acc[c][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};

  // out = p·v over chunks of 8 keys.  The mma's k-index j < 4 stands for key
  // 8c + 2j and k-index j + 4 for key 8c + 2j + 1, so the A fragment (rows
  // g, g+8 at k-indices t, t+4) is the C fragment of the logits as it lies:
  // a0 = c0 (g, key 2t), a1 = c2 (g+8, key 2t), a2 = c1 (g, key 2t+1),
  // a3 = c3 (g+8, key 2t+1); the B fragment (k-indices t, t+4 at column g)
  // is V's rows 2t and 2t+1, one pair of split V.  The sum over keys does not
  // depend on their order, so nothing else changes.  o_acc[dt] holds columns
  // 8dt..8dt+7.
  float o_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.0f;
  const float* vr = kSplit ? v_s + t * PV + 2 * g : v_s + 2 * t * PV + g;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(s_acc[c][0] * inv[0], a_hi[0], a_lo[0]);
    split_tf32(s_acc[c][2] * inv[1], a_hi[1], a_lo[1]);
    split_tf32(s_acc[c][1] * inv[0], a_hi[2], a_lo[2]);
    split_tf32(s_acc[c][3] * inv[1], a_hi[3], a_lo[3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b_hi[2], b_lo[2];
      if constexpr (kSplit) {
        const uint2 h = *reinterpret_cast<const uint2*>(vr + 4 * c * PV + 16 * dt);
        const uint2 l = *reinterpret_cast<const uint2*>(vr + 4 * c * PV + 2 * D + 16 * dt);
        b_hi[0] = h.x;
        b_hi[1] = h.y;
        b_lo[0] = l.x;
        b_lo[1] = l.y;
      } else {
        split_tf32(vr[8 * c * PV + 8 * dt], b_hi[0], b_lo[0]);
        split_tf32(vr[(8 * c + 1) * PV + 8 * dt], b_hi[1], b_lo[1]);
      }
      mma_3xtf32(o_acc[dt], a_hi, a_lo, b_hi, b_lo);
    }
  }

  store_rows<D, kNarrow>(o_acc, q_s + row0 * P, P,
                         out + ((size_t)n * Lq + q0 + row0) * ldv + head * dv, ldv,
                         rows - row0, dv, lane);
}

template <int D, int KC, bool kNarrow>
int launch_f32tc_tiles(const void* q, const void* k, const void* v, void* out,
                       int N, int Lq, int S, int heads, int dk, int dv,
                       cudaStream_t stream) {
  static SmemOptIn opt_in;
  constexpr size_t smem = f32tc_smem_bytes(D, KC, f32tc_split_once(D, KC));
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_f32tc_kernel<D, KC, kNarrow>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kF32Tile - 1) / kF32Tile;
  const long long blocks = (long long)N * heads * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_f32tc_kernel<D, KC, kNarrow>
      <<<(unsigned)blocks, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Lq, S, heads, dk,
      dv, tiles, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

// Shared memory of one block of cross_modal_attn_f32tc_blocks_kernel<D, KC>:
// the 128-row Q tile in rows of D + 8 floats, one key block of 8·KC keys
// split (K's rows of 2D + 8, V's pairs of rows of 4D + 8, as
// f32tc_smem_bytes lays them out), then the next key block's K and V as
// they are, in rows of D floats.
__host__ __device__ constexpr size_t f32tc_blocks_smem_bytes(int D, int KC) {
  return sizeof(float) * ((size_t)kF32Tile * (D + 8) + (size_t)8 * KC * (2 * D + 8) +
                          (size_t)4 * KC * (4 * D + 8) + (size_t)16 * KC * D);
}

// 8-key chunks of one key block: 32 keys up to D = 128 (see the note at the
// top); 8 at D = 256, where the 128-row Q tile alone takes 135,168 bytes and
// a key block of 16 keys with its raw buffer would need 234,240
constexpr int kF32KeyChunks = 4;
constexpr int kF32KeyChunksD256 = 1;

// S > 128, or D = 256 at any S: the keys streamed in key blocks of 8·KC
// with an online softmax.  D: d_k and d_v rounded up to 32, 64, 128 or
// 256; kNarrow: the copy width, as above.  The query tiles, warps,
// fragments and split layouts are those of cross_modal_attn_f32tc_kernel;
// the tiles are zero past Lq, S, d_k and d_v.  Every warp copies and
// splits, and meets the barriers, including a warp with no query rows in
// a partial tile, which multiplies nothing.  Its register budget allows 16
// more a thread than the kernel above (the running max and sums and the
// copy's addresses live across the key-block loop; at 40, D = 32 spilled);
// at D = 256 one block an SM (184,704 bytes), so up to 255 registers a
// thread for its 128 output accumulators.
template <int D, int KC, bool kNarrow>
__global__ void __launch_bounds__(kF32Warps * 32,
                                  f32tc_blocks_an_sm(D, KC, 56, f32tc_blocks_smem_bytes(D, KC)))
cross_modal_attn_f32tc_blocks_kernel(const float* __restrict__ q,  // (N, Lq, h*dk)
                                     const float* __restrict__ k,  // (N, S, h*dk)
                                     const float* __restrict__ v,  // (N, S, h*dv)
                                     float* __restrict__ out,      // (N, Lq, h*dv)
                                     int Lq, int S, int heads, int dk, int dv, int tiles,
                                     float scale) {
  constexpr int P = D + 8, PK = 2 * D + 8, PV = 4 * D + 8;  // pitches, as above
  constexpr int kRows = 8 * KC;   // keys of one key block
  constexpr int kChunks = D / 4;  // 16-byte chunks in one row of a tile
  constexpr int kThreads = kF32Warps * 32;
  constexpr int kKItems = kRows * kChunks, kVItems = kRows / 2 * kChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (128, P)
  float* k_s = q_s + kF32Tile * P;                   // (kRows, PK), split
  float* v_s = k_s + kRows * PK;                     // (kRows / 2, PV), split
  float* k_raw = v_s + kRows / 2 * PV;               // (kRows, D), the copy in flight
  float* v_raw = k_raw + kRows * D;                  // (kRows, D)

  const int b = blockIdx.x;
  const int nh = b / tiles;  // n * heads + head
  const int q0 = (b - nh * tiles) * kF32Tile;
  const int n = nh / heads, head = nh - n * heads;
  const int ldk = heads * dk, ldv = heads * dv;  // row strides
  const float* qb = q + ((size_t)n * Lq + q0) * ldk + head * dk;
  const float* kb = k + (size_t)n * S * ldk + head * dk;
  const float* vb = v + (size_t)n * S * ldv + head * dv;
#pragma unroll
  for (int j = 0; j < kF32Tile * kChunks / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    cp_async_f4<kNarrow>(q_s + r * P + c, qb + (size_t)r * ldk + c, q, q0 + r < Lq, dk - c);
  }
  // keys s0 .. s0 + kRows - 1 into the raw buffers, zero past S, d_k and d_v
  auto copy_block = [&](int s0) {
#pragma unroll
    for (int j = 0; j < (kKItems + kThreads - 1) / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (kKItems % kThreads == 0 || i < kKItems) {
        const int r = i / kChunks, c = (i % kChunks) * 4;
        const bool ok = s0 + r < S;
        cp_async_f4<kNarrow>(k_raw + r * D + c, kb + (size_t)(s0 + r) * ldk + c, k, ok, dk - c);
        cp_async_f4<kNarrow>(v_raw + r * D + c, vb + (size_t)(s0 + r) * ldv + c, v, ok, dv - c);
      }
    }
  };
  copy_block(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int rows = min(kF32Tile, Lq - q0);
  const bool has_rows = row0 < rows;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = scale * 1.4426950408889634f;
  const float* qa = q_s + (row0 + g) * P + 2 * t;
  const float* kr = k_s + g * PK + 2 * t;
  const float* vr = v_s + t * PV + 2 * g;
  // o_acc[dt] holds columns 8dt..8dt+7 (rows g, g+8), as above
  float o_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY};  // running row max (base 2)
  float sum[2] = {0.0f, 0.0f};           // the lane's share of the row sum

  const int n_blocks = (S + kRows - 1) / kRows;
  for (int blk = 0; blk < n_blocks; ++blk) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // this key block has landed; no warp reads the split tiles
    // split K (items: 4 dims of one key) and V (4 columns of a pair of keys)
#pragma unroll
    for (int j = 0; j < (kKItems + kThreads - 1) / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (kKItems % kThreads == 0 || i < kKItems) {
        const int r = i / kChunks, c = (i % kChunks) * 4;
        split_key4(k_s + r * PK + c, D, *reinterpret_cast<const float4*>(k_raw + r * D + c));
      }
    }
#pragma unroll
    for (int j = 0; j < (kVItems + kThreads - 1) / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (kVItems % kThreads == 0 || i < kVItems) {
        const int rp = i / kChunks, c = (i % kChunks) * 4;
        split_key_pair4(v_s + rp * PV + 2 * c, D,
                        *reinterpret_cast<const float4*>(v_raw + 2 * rp * D + c),
                        *reinterpret_cast<const float4*>(v_raw + (2 * rp + 1) * D + c));
      }
    }
    __syncthreads();  // the split tiles are written; the raw buffers are free
    if (blk + 1 < n_blocks) copy_block((blk + 1) * kRows);  // in flight while we multiply
    if (!has_rows) continue;

    // logits of the key block: s_acc[c] holds keys s0 + 8c..+7, q·kᵀ in the
    // contraction order of cross_modal_attn_f32tc_kernel
    float s_acc[KC][4];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[c][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < D / 8; ++kt) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kt);
      const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * P + 8 * kt);
      uint32_t a_hi[4], a_lo[4];
      split_tf32(x0.x, a_hi[0], a_lo[0]);
      split_tf32(x1.x, a_hi[1], a_lo[1]);
      split_tf32(x0.y, a_hi[2], a_lo[2]);
      split_tf32(x1.y, a_hi[3], a_lo[3]);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const uint2 h = *reinterpret_cast<const uint2*>(kr + 8 * c * PK + 8 * kt);
        const uint2 l = *reinterpret_cast<const uint2*>(kr + 8 * c * PK + D + 8 * kt);
        const uint32_t b_hi[2] = {h.x, h.y}, b_lo[2] = {l.x, l.y};
        mma_3xtf32(s_acc[c], a_hi, a_lo, b_hi, b_lo);
      }
    }

    // online softmax in base 2; a row lives in the 4 lanes of a quad
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[c][e] *= scale2;
    const int valid = S - blk * kRows;  // keys of this block below S
    if (valid < kRows) {  // the last key block: keys past S (zero rows of K) are -inf
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * c + 2 * t + (e & 1) >= valid) s_acc[c][e] = -INFINITY;
    }
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s_acc[c][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
      bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
      const float m = fmaxf(mx[h], bm[h]);  // finite: every key block holds a key below S
      const float alpha = exp2f(mx[h] - m);  // 0 at the first key block
      sum[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o_acc[dt][2 * h] *= alpha;
        o_acc[dt][2 * h + 1] *= alpha;
      }
      mx[h] = m;
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s_acc[c][e] - mx[e >> 1]);
        s_acc[c][e] = p;
        sum[e >> 1] += p;
      }

    // o += p·v, p unnormalised, in the fragment order of
    // cross_modal_attn_f32tc_kernel (the logits' C fragment is p's A fragment)
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(s_acc[c][0], a_hi[0], a_lo[0]);
      split_tf32(s_acc[c][2], a_hi[1], a_lo[1]);
      split_tf32(s_acc[c][1], a_hi[2], a_lo[2]);
      split_tf32(s_acc[c][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint2 h = *reinterpret_cast<const uint2*>(vr + 4 * c * PV + 16 * dt);
        const uint2 l = *reinterpret_cast<const uint2*>(vr + 4 * c * PV + 2 * D + 16 * dt);
        const uint32_t b_hi[2] = {h.x, h.y}, b_lo[2] = {l.x, l.y};
        mma_3xtf32(o_acc[dt], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  if (!has_rows) return;  // no barrier follows

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const float inv = 1.0f / sum[h];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o_acc[dt][2 * h] *= inv;
      o_acc[dt][2 * h + 1] *= inv;
    }
  }
  store_rows<D, kNarrow>(o_acc, q_s + row0 * P, P,
                         out + ((size_t)n * Lq + q0 + row0) * ldv + head * dv, ldv,
                         rows - row0, dv, lane);
}

template <int D, bool kNarrow>
int launch_f32tc_blocks(const void* q, const void* k, const void* v, void* out, int N,
                        int Lq, int S, int heads, int dk, int dv, cudaStream_t stream) {
  constexpr int KC = D <= 128 ? kF32KeyChunks : kF32KeyChunksD256;
  static SmemOptIn opt_in;
  constexpr size_t smem = f32tc_blocks_smem_bytes(D, KC);
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_f32tc_blocks_kernel<D, KC, kNarrow>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kF32Tile - 1) / kF32Tile;
  const long long blocks = (long long)N * heads * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_f32tc_blocks_kernel<D, KC, kNarrow>
      <<<(unsigned)blocks, kF32Warps * 32, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), Lq, S, heads, dk,
          dv, tiles, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

// The keys whole (S <= 128, D <= 128) or, where key_blocks, streamed in
// key blocks (any S); D = 256 only in key blocks.
template <int D, bool kNarrow>
int launch_f32tc(const void* q, const void* k, const void* v, void* out, int N,
                 int Lq, int S, int heads, int dk, int dv, bool key_blocks,
                 cudaStream_t s) {
  if (key_blocks)
    return launch_f32tc_blocks<D, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if constexpr (D <= 128) {
    if (S <= 16)
      return launch_f32tc_tiles<D, 2, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
    if (S <= 32)
      return launch_f32tc_tiles<D, 4, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
    if (S <= 64)
      return launch_f32tc_tiles<D, 8, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
    if (S <= 128)
      return launch_f32tc_tiles<D, 16, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kNarrow>
int launch_f32tc_width(const void* q, const void* k, const void* v, void* out, int N,
                       int Lq, int S, int heads, int dk, int dv, bool key_blocks,
                       cudaStream_t s) {
  const int d = dk > dv ? dk : dv;
  if (d <= 32)
    return launch_f32tc<32, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, s);
  if (d <= 64)
    return launch_f32tc<64, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, s);
  if (d <= 128)
    return launch_f32tc<128, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, s);
  return launch_f32tc<256, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, s);
}

int launch_f32tc_any(const void* q, const void* k, const void* v, void* out,
                     int N, int Lq, int S, int heads, int dk, int dv, bool key_blocks,
                     bool narrow, cudaStream_t s) {
  if (narrow)
    return launch_f32tc_width<true>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, s);
  if (dk % 4 || dv % 4) return (int)cudaErrorInvalidValue;  // 16-byte copies straddle d
  return launch_f32tc_width<false>(q, k, v, out, N, Lq, S, heads, dk, dv, key_blocks, s);
}

// ---------------------------------------------- wide heads, either dtype

constexpr int kWideWarps = 4;   // 16 query rows each: 64-row query tiles
constexpr int kWideTile = 16 * kWideWarps;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideKeys = 32;   // keys of a key block: 4 n-tiles of 8
constexpr int kWideChunk = 32;  // d_k columns of a chunk of q·kᵀ
constexpr int kWideSlice = 128;  // the most d_v columns of a block (its slice)
constexpr int kWideStages = 3;  // chunks (of Q and K) in the ring

// Row pitches in elements of T, as the values lie (no split): Q's and K's
// chunks in rows of kWideChunk + 8 (40 floats ≡ 8 (mod 32) words, so each
// 64-bit fragment load of 8 rows × 4 column pairs falls in 32 banks a half
// warp; 40 bf16 are 20 words, and a 32-bit load of a pair of them from 8
// rows × 4 pairs falls in 32 banks), V's slice in rows of kWideSlice + 4
// floats (132 ≡ 4 (mod 32): the 32-bit loads of keys 2t and 2t + 1 at
// column g fall in 32 banks) or + 8 bf16 (68 words: the pairs g, g + 1 share
// a word); every row starts on a 16-byte boundary.
template <typename T>
struct WidePitch {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kQK = kWideChunk + 8;
  static constexpr int kV = kWideSlice + (kF32 ? 4 : 8);
  static constexpr int kStage = (kWideTile + kWideKeys) * kQK;  // Q then K, elements
};

// Shared memory of one block of cross_modal_attn_wide_kernel<T>: the ring
// of kWideStages stages (a Q chunk and a K chunk each) and one V slice of a
// key block, in elements of T, whatever the sizes.
template <typename T>
__host__ __device__ constexpr size_t wide_smem_bytes() {
  return sizeof(T) * ((size_t)kWideStages * WidePitch<T>::kStage +
                      (size_t)kWideKeys * WidePitch<T>::kV);
}

// Two consecutive values of a row in shared memory as tf32 operand bits:
// float32 (64-bit load) split into hi and lo (kExact false), or bf16 (32-bit
// load), whose values are tf32 values already (hi only)
template <typename T>
__device__ __forceinline__ void pair_operands(const T* p, uint32_t& h0, uint32_t& h1,
                                              uint32_t& l0, uint32_t& l1) {
  if constexpr (std::is_same<T, float>::value) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    split_tf32(x.x, h0, l0);
    split_tf32(x.y, h1, l1);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    h0 = w << 16;
    h1 = w & 0xffff0000u;
  }
}

// One value in shared memory as tf32 operand bits (hi, and lo for float32)
template <typename T>
__device__ __forceinline__ void one_operand(const T* p, uint32_t& h, uint32_t& l) {
  if constexpr (std::is_same<T, float>::value) {
    split_tf32(*p, h, l);
  } else {
    h = (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16;
  }
}

// `count` values of a row at src into shared memory at dst, zero past the
// row's ``left`` values below d or where the row is not valid: 16-byte
// cp.async copies (4 floats, 8 bf16; the pointers and d allow them unless
// kNarrow), or one value a copy: a 4-byte cp.async for a float, a plain
// load and store for a bf16 value (no cp.async moves 2 bytes)
template <typename T, bool kNarrow>
__device__ __forceinline__ void copy_values(T* dst, const T* src, const T* any, bool row_ok,
                                            int left) {
  constexpr int kVec = 16 / sizeof(T);
  if constexpr (!kNarrow) {
    const bool ok = row_ok && left > 0;
    cp_async16(dst, ok ? src : any, ok);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const bool ok = row_ok && e < left;
      cp_async4(dst + e, ok ? src + e : any, ok);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = ldg_bf16(src + e, row_ok && e < left);
  }
}

// Blocks of the wide kernel an SM should hold: 3 (170 registers a thread),
// but 2 for float32 one value a copy, whose 4-byte copies' addresses
// spilled at 170
template <typename T, bool kNarrow>
constexpr int wide_blocks_an_sm() {
  return kNarrow && std::is_same<T, float>::value ? 2 : 3;
}

// Heads past the tensor-core kernels' D: float32 with d_k or d_v above 256
// and bfloat16 above 128, at any S, d_k, d_v and alignment.  Replaces, for
// those shapes, the CUDA-core kernel (cross_modal_attn_kernel above), which
// read K and V from L2 once for every query row (about 33 GB of cache
// traffic a call at d = 260, h = 2, S = 200, N = 200: 8.1 ms on the H100
// against SDPA's 0.72).  What bounds the work: three tf32 products at 495
// TFLOP/s, 0.10 ms at that shape, about as long as its bytes at 3.35 TB/s.
// The design: one block of 4 warps per (example, head, 64-query tile, d_v
// slice), slice fastest, then tile, so the blocks of one head run side by
// side and find its K and V in L2; each warp takes 16 query rows.  The keys
// stream in key blocks of 32 with an online softmax, as in
// cross_modal_attn_f32tc_blocks_kernel; each key block's K and V are copied
// once into shared memory for the whole query tile.  The logits of a key
// block accumulate over d_k in chunks of 32 columns, the Q and K chunks
// passing through a ring of kWideStages stages, zero past d_k, so d_k is
// padded to a multiple of 32 only (260 to 288).  p·v then runs over the
// block's slice of d_v (at most 128 columns, 64 output accumulators a
// thread; ceil(d_v / 128) slices of even width, a multiple of 8), and the
// logits are recomputed once a slice.  The values are copied as they lie,
// by cp.async, the chunks two stages ahead of the one the warps multiply
// and the key block's V slice with its first chunk, so the copies overlap
// the products (one stage ahead, a stage waited on its loads); one barrier
// a chunk, one before p·v.  float32 (T =
// float): both products in 3xTF32, as in the tensor-core kernels, each warp
// splitting the fragments it reads.  bfloat16: a bf16 value has 8
// significant bits and tf32 11, so it is a tf32 value (its bits shifted up
// by 16) and one tf32 product of two of them is exact in float32, as the
// bf16 mma's is.  p (unnormalised, against the running row max) is rounded
// to bf16 once before p·v (kRoundP) or split into tf32 hi + lo, 21 bits,
// finer than p_hi + p_lo's 16, two products; the output is divided by the
// float32 sum at the end.  kNarrow: one value a copy, for pointers or d off
// the 16-byte copies (float32: d a multiple of 4; bfloat16: of 8).  What
// holds float32 back: each of the 4 warps splits every K and V value it
// reads into tf32 hi and lo (scripts/wide_attention_probe.py times it).
template <typename T, bool kRoundP, bool kNarrow>
__global__ void __launch_bounds__(kWideThreads, wide_blocks_an_sm<T, kNarrow>())
cross_modal_attn_wide_kernel(const T* __restrict__ q,  // (N, Lq, h*dk)
                             const T* __restrict__ k,  // (N, S, h*dk)
                             const T* __restrict__ v,  // (N, S, h*dv)
                             T* __restrict__ out,      // (N, Lq, h*dv)
                             int Lq, int S, int heads, int dk, int dv, int tiles, int slices,
                             int width, float scale) {
  using Pitch = WidePitch<T>;
  constexpr bool kExact = !Pitch::kF32;  // bf16 values: no lo parts
  constexpr int kVec = 16 / sizeof(T);   // values of a 16-byte copy
  constexpr int kPQ = Pitch::kQK, kPV = Pitch::kV;
  constexpr int kQItems = kWideTile * kWideChunk / kVec;  // copies of a Q chunk
  constexpr int kKItems = kWideKeys * kWideChunk / kVec;  // of a K chunk
  constexpr int kVItems = kWideKeys * kWideSlice / kVec;  // of a V slice
  static_assert(kQItems % kWideThreads == 0 && kKItems % kWideThreads == 0 &&
                    kVItems % kWideThreads == 0,
                "whole rounds of copies");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);     // kWideStages × (Q (64, kPQ), K (32, kPQ))
  T* v_s = ring + kWideStages * Pitch::kStage;  // (32, kPV)

  int b = blockIdx.x;
  const int slice = b % slices;
  b /= slices;
  const int tile = b % tiles, nh = b / tiles;  // nh = n * heads + head
  const int n = nh / heads, head = nh - n * heads;
  const int q0 = tile * kWideTile, c0 = slice * width;  // first query row, first d_v column
  const int cols = min(width, dv - c0);                  // d_v columns of this slice
  const int ldk = heads * dk, ldv = heads * dv;
  const T* qb = q + ((size_t)n * Lq + q0) * ldk + head * dk;
  const T* kb = k + (size_t)n * S * ldk + head * dk;
  const T* vb = v + (size_t)n * S * ldv + head * dv + c0;
  const int n_chunks = (dk + kWideChunk - 1) / kWideChunk;
  const int n_blocks = (S + kWideKeys - 1) / kWideKeys;
  const int stages = n_chunks * n_blocks;  // (key block, chunk) in order

  // stage i (chunk i % n_chunks of key block i / n_chunks) into its ring slot
  auto copy_stage = [&](int i) {
    if (i >= stages) return;
    const int blk = i / n_chunks, d0 = (i - blk * n_chunks) * kWideChunk;
    T* q_s = ring + (i % kWideStages) * Pitch::kStage;
    T* k_s = q_s + kWideTile * kPQ;
#pragma unroll
    for (int j = 0; j < kQItems / kWideThreads; ++j) {
      const int it = j * kWideThreads + threadIdx.x;
      const int r = it / (kWideChunk / kVec), c = (it % (kWideChunk / kVec)) * kVec;
      copy_values<T, kNarrow>(q_s + r * kPQ + c, qb + (size_t)r * ldk + d0 + c, q, q0 + r < Lq,
                              dk - d0 - c);
    }
#pragma unroll
    for (int j = 0; j < kKItems / kWideThreads; ++j) {
      const int it = j * kWideThreads + threadIdx.x;
      const int r = it / (kWideChunk / kVec), c = (it % (kWideChunk / kVec)) * kVec;
      const int key = blk * kWideKeys + r;
      copy_values<T, kNarrow>(k_s + r * kPQ + c, kb + (size_t)key * ldk + d0 + c, k, key < S,
                              dk - d0 - c);
    }
  };
  // key block blk's slice of V, zero past S and past the slice's columns
  auto copy_v = [&](int blk) {
#pragma unroll
    for (int j = 0; j < kVItems / kWideThreads; ++j) {
      const int it = j * kWideThreads + threadIdx.x;
      const int r = it / (kWideSlice / kVec), c = (it % (kWideSlice / kVec)) * kVec;
      const int key = blk * kWideKeys + r;
      copy_values<T, kNarrow>(v_s + r * kPV + c, vb + (size_t)key * ldv + c, v, key < S,
                              cols - c);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int rows = min(kWideTile, Lq - q0);
  const bool has_rows = row0 < rows;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = scale * 1.4426950408889634f;
  float o_acc[kWideSlice / 8][4];  // o_acc[dt]: columns 8dt..8dt+7 of the slice
#pragma unroll
  for (int dt = 0; dt < kWideSlice / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY};  // running row max (base 2)
  float sum[2] = {0.0f, 0.0f};           // the lane's share of the row sum

  copy_v(0);
  copy_stage(0);
  cp_async_commit();
  copy_stage(1);
  cp_async_commit();
  for (int blk = 0; blk < n_blocks; ++blk) {
    // logits of the key block: s_acc[c] holds keys 8c..8c+7 (rows g, g + 8),
    // q·kᵀ in the contraction order of cross_modal_attn_f32tc_kernel
    float s_acc[kWideKeys / 8][4];
#pragma unroll
    for (int c = 0; c < kWideKeys / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[c][e] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int i = blk * n_chunks + ch;
      cp_async_wait<kWideStages - 2>();  // this thread's copies of stage i have landed
      __syncthreads();  // every thread's have; no warp reads the slot refilled next, or V
      if (ch == 0 && blk > 0) copy_v(blk);  // p·v of the key block before is done
      copy_stage(i + kWideStages - 1);
      cp_async_commit();  // empty past the last stage, to keep the count
      if (!has_rows) continue;
      const T* q_s = ring + (i % kWideStages) * Pitch::kStage;
      const T* qa = q_s + (row0 + g) * kPQ + 2 * t;
      const T* kr = q_s + kWideTile * kPQ + g * kPQ + 2 * t;
#pragma unroll
      for (int kt = 0; kt < kWideChunk / 8; ++kt) {
        uint32_t a_hi[4], a_lo[4];
        pair_operands(qa + 8 * kt, a_hi[0], a_hi[2], a_lo[0], a_lo[2]);
        pair_operands(qa + 8 * kPQ + 8 * kt, a_hi[1], a_hi[3], a_lo[1], a_lo[3]);
#pragma unroll
        for (int c = 0; c < kWideKeys / 8; ++c) {
          uint32_t b_hi[2], b_lo[2];
          pair_operands(kr + 8 * c * kPQ + 8 * kt, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
          if constexpr (kExact)
            mma_tf32(s_acc[c], a_hi, b_hi[0], b_hi[1]);
          else
            mma_3xtf32(s_acc[c], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }
    // V of this key block has landed: its group is older than the newest
    // one unless the key block has one chunk
    if (n_chunks == 1)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();
    if (!has_rows) continue;

    // online softmax in base 2; a row lives in the 4 lanes of a quad
    const int valid = S - blk * kWideKeys;  // keys of this block below S
#pragma unroll
    for (int c = 0; c < kWideKeys / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_acc[c][e] = 8 * c + 2 * t + (e & 1) < valid ? s_acc[c][e] * scale2 : -INFINITY;
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < kWideKeys / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s_acc[c][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
      bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
      const float m = fmaxf(mx[h], bm[h]);  // finite: every key block holds a key below S
      const float alpha = exp2f(mx[h] - m);  // 0 at the first key block
      sum[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < kWideSlice / 8; ++dt) {
        o_acc[dt][2 * h] *= alpha;
        o_acc[dt][2 * h + 1] *= alpha;
      }
      mx[h] = m;
    }
#pragma unroll
    for (int c = 0; c < kWideKeys / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s_acc[c][e] - mx[e >> 1]);
        s_acc[c][e] = p;
        sum[e >> 1] += p;
      }

    // o += p·v over the slice's columns, in the fragment order of
    // cross_modal_attn_f32tc_kernel (the logits' C fragment is p's A
    // fragment; B is V's rows 8c + 2t and 8c + 2t + 1 at column 8dt + g)
    const T* vr = v_s + 2 * t * kPV + g;
#pragma unroll
    for (int c = 0; c < kWideKeys / 8; ++c) {
      uint32_t a_hi[4], a_lo[4];
      const float pa[4] = {s_acc[c][0], s_acc[c][2], s_acc[c][1], s_acc[c][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kExact && kRoundP)
          a_hi[e] = __float_as_uint(__bfloat162float(__float2bfloat16_rn(pa[e])));
        else
          split_tf32(pa[e], a_hi[e], a_lo[e]);
      }
#pragma unroll
      for (int dt = 0; dt < kWideSlice / 8; ++dt) {
        if (8 * dt < cols) {
          uint32_t b_hi[2], b_lo[2];
          one_operand(vr + 8 * c * kPV + 8 * dt, b_hi[0], b_lo[0]);
          one_operand(vr + (8 * c + 1) * kPV + 8 * dt, b_hi[1], b_lo[1]);
          if constexpr (kExact) {
            if constexpr (!kRoundP) mma_tf32(o_acc[dt], a_lo, b_hi[0], b_hi[1]);
            mma_tf32(o_acc[dt], a_hi, b_hi[0], b_hi[1]);
          } else {
            mma_3xtf32(o_acc[dt], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
    }
  }
  if (!has_rows) return;  // no barrier follows

  // rows g and g + 8 of the warp, the slice's columns below d_v
  T* ob = out + ((size_t)n * Lq + q0 + row0) * ldv + head * dv + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const float inv = 1.0f / sum[h];
    const int r = g + 8 * h;
    if (row0 + r >= rows) continue;
#pragma unroll
    for (int dt = 0; dt < kWideSlice / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dt + 2 * t + e;
        if (c < cols) {
          const float o = o_acc[dt][2 * h + e] * inv;
          if constexpr (kExact)
            ob[(size_t)r * ldv + c] = __float2bfloat16_rn(o);
          else
            ob[(size_t)r * ldv + c] = o;
        }
      }
  }
}

// Slices of d_v: ceil(d_v / 128), of even width, a multiple of 8
__host__ __device__ constexpr int wide_slices(int dv) {
  return (dv + kWideSlice - 1) / kWideSlice;
}

__host__ __device__ constexpr int wide_width(int dv) {
  return ((dv + wide_slices(dv) - 1) / wide_slices(dv) + 7) / 8 * 8;
}

template <typename T, bool kRoundP, bool kNarrow>
int launch_wide_as(const void* q, const void* k, const void* v, void* out, int N, int Lq,
                   int S, int heads, int dk, int dv, cudaStream_t stream) {
  static SmemOptIn opt_in;
  constexpr size_t smem = wide_smem_bytes<T>();
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_wide_kernel<T, kRoundP, kNarrow>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kWideTile - 1) / kWideTile, slices = wide_slices(dv);
  const long long blocks = (long long)N * heads * tiles * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_wide_kernel<T, kRoundP, kNarrow>
      <<<(unsigned)blocks, kWideThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), Lq, S, heads, dk, dv, tiles, slices, wide_width(dv),
          1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

int launch_wide(const void* q, const void* k, const void* v, void* out, int N, int Lq, int S,
                int heads, int dk, int dv, bool bf16, bool narrow, bool round_p,
                cudaStream_t s) {
  if (!bf16 && narrow)
    return launch_wide_as<float, false, true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (!bf16) return launch_wide_as<float, false, false>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (round_p && narrow)
    return launch_wide_as<__nv_bfloat16, true, true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (round_p)
    return launch_wide_as<__nv_bfloat16, true, false>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (narrow)
    return launch_wide_as<__nv_bfloat16, false, true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  return launch_wide_as<__nv_bfloat16, false, false>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
}

}  // namespace

// route: 0 = float32 on the CUDA cores (the first kernel; the wrapper sends
// no call there, it is reached only when forced), 1 = bfloat16 with a
// head's keys whole, 2 = float32 on the tensor cores with a head's keys
// whole, 3 = float32 on the tensor cores with the keys streamed in key
// blocks, 4 = bfloat16 with the keys streamed in key blocks, 5 and 6 =
// the wide-head kernel in float32 and in bfloat16 (q, k, v and out share
// the dtype).  The bfloat16 routes take dk = dv, a multiple of 16 up to
// 128, with q, k, v and out aligned to 16 bytes, route 1 S <= 128 and route
// 4 any S >= 1; with narrow, route 4 takes any dk and dv from 1 to 128 (the
// instance's D their larger rounded up to 16) from any 2-byte-aligned
// pointer, one value a copy (the kFill instance).  The
// tensor-core float32 routes take any dk and dv from 1, route 2 up to 128
// and S <= 128, route 3 up to 256 and any S >= 1 (the wrapper sends S >
// 128 and d above 128 to route 3, and S > 128 to route 4; a smaller S only
// to time them against routes 1 and 2); routes 5 and 6 take any dk, dv
// and S from 1 (the wrapper sends float32 d above 256 and bfloat16 d above
// 128 there).  narrow (routes 2-6) copies one value at a time, for
// pointers aligned only to their element size or d off a multiple of 4
// (float32), or of 8 (the wide kernel in bfloat16), and is required there;
// for route 4 it is the zero-filled instance, for every bf16 call but the
// aligned dk = dv, a multiple of 16.  The CUDA-core
// float32 route takes any sizes whose q rows and probabilities fit in
// shared memory.  round_p (for the bfloat16 routes only): p rounded to bf16
// once before p·v, as XLA's attention in the JAX package rounds it
// (TPU.PALLAS_ATTENTION off, the default); without it p keeps about 16
// bits (p_hi + p_lo; the wide kernel 21), as the Pallas kernel's float32 p.
extern "C" int cross_modal_attn(const void* q, const void* k, const void* v,
                                void* out, int N, int Lq, int S, int heads,
                                int dk, int dv, int route, int narrow, int round_p,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || dk < 1 || dv < 1) return (int)cudaErrorInvalidValue;
  if (narrow && (route < 2 || route > 6)) return (int)cudaErrorInvalidValue;
  if (round_p && route != 1 && route != 4 && route != 6) return (int)cudaErrorInvalidValue;
  if (route == 0) return launch_f32(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if ((route == 1 && !narrow && dk == dv && dk % 16 == 0 && dk <= 128) ||
      (route == 4 && dk <= 128 && dv <= 128 && (narrow || (dk == dv && dk % 16 == 0))))
    return launch_bf16_any(q, k, v, out, N, Lq, S, heads, dk, dv, route == 4, narrow != 0,
                           round_p != 0, s);
  const int d_max = route == 3 ? 256 : 128;
  if ((route == 2 || route == 3) && dk <= d_max && dv <= d_max)
    return launch_f32tc_any(q, k, v, out, N, Lq, S, heads, dk, dv, route == 3, narrow != 0, s);
  if ((route == 5 || route == 6) &&
      (narrow || (route == 5 ? dk % 4 == 0 && dv % 4 == 0 : dk % 8 == 0 && dv % 8 == 0)))
    return launch_wide(q, k, v, out, N, Lq, S, heads, dk, dv, route == 6, narrow != 0,
                       round_p != 0, s);
  return (int)cudaErrorInvalidValue;
}
