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
// is the larger of d_k and d_v rounded up to 16, each of q, k and v is
// copied by the widest cp.async its pointer and d allow or by shifted
// 16-byte loads, zero past d_k and d_v, and the output leaves in 16-byte
// words (the kernel's note); the instances the aligned calls take are
// unchanged by it.
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
// float32 on the tensor cores past S = 128 at D = 32 and 64: key blocks
// on mma.sync (D = 128 and 256 take the warpgroup-MMA kernel, below).
// Holding a head's
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
// for the window's two calls (chip_smoke.py phase 3b times both).  At D
// = 64 the warpgroup-MMA design below lost to this kernel at S = 144 on the
// H100 (0.1676 against 0.147 ms at N = 200, h = 4, with two stages of K and
// Vᵀ), so D = 32 and 64 stay here.
//
// float32 past S = 128 at D = 128, and at every S at D = 256 (where no
// whole-key instance fits): key blocks on warpgroup MMA
// (cross_modal_attn_f32wg_blocks_kernel, its note below), 3xTF32.  Its
// mma.sync predecessor (32-key blocks at D = 128, 8-key blocks at D = 256,
// 8 warps of 16 query rows) ran at mma.sync's ceiling of about 81 TFLOP/s
// and lost to SDPA at D = 256.
//
// Wide heads, float32 with d_k or d_v above 256 and bfloat16 above 128, any
// S and alignment: cross_modal_attn_wide_f32_kernel on warpgroup MMA and
// cross_modal_attn_wide_bf16_kernel on bf16 mma.sync (their notes below),
// one pass over d_v up to 272 columns, the Q tile read once.
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
constexpr int kBf16FillStages = 4;  // the same, of the fill instance (see the kernel)
constexpr int kBf16MoreRegs = 48;   // registers a thread beyond the accumulators
constexpr int kBf16FillRegs = 40;   // the same, more, for kFill's copies and shifts
constexpr float kBf16MaxSlack = 8.0f;  // log2 of the largest p before a rescale

// Shared memory of one block of cross_modal_attn_bf16_blocks_kernel<D>: the
// Q tile (16 rows a warp) and the ring's stages (kBf16Stages, or with kFill
// kBf16FillStages), each the K and V of one key block of 16·kBf16KeyChunks
// keys, all in rows of D + kPad values, whatever S.
__host__ __device__ constexpr size_t bf16_blocks_smem_bytes(int D, bool kFill = false) {
  return sizeof(__nv_bfloat16) * (D + kPad) *
         (16 * kBf16BlockWarps +
          2 * (kFill ? kBf16FillStages : kBf16Stages) * 16 * kBf16KeyChunks);
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
  const int by_smem = 233472 / (int)(bf16_blocks_smem_bytes(D, kFill) + 1024);
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

// ------------------------- bf16 rows aligned only to their 2-byte element
//
// Rows of a head's d values lie heads·d values apart and a head d values on,
// so every row starts on a multiple of w bytes when the tensor's pointer and
// the row's 2d bytes are multiples of w.  A row is copied in 16-byte chunks
// of 8 values into shared memory: by one 16-byte cp.async, two of 8 bytes or
// four of 4 (the widest w of kWidestCopy, 8 and kNarrowestCopy that the
// pointer and d allow), each with its source size cut at the row's end so
// that the rest of the chunk is zero-filled; where no w of 4 or more
// divides both (odd d, or a pointer off 4 bytes), by a shifted load: the two
// aligned 16-byte words that cover the chunk, loaded whole (never past the
// 16-byte word that holds the row's last value) and shifted by the row's
// offset in its word (which varies from row to row where d is odd), then
// one 16-byte store.  No copy moves 2 bytes.
constexpr int kWidestCopy = 16;    // bytes of the widest copy
constexpr int kNarrowestCopy = 4;  // of the narrowest cp.async; below it, shifted loads
constexpr int kShiftedLoad = 0;    // the width code of a shifted load

// The copy width of rows of d bf16 values at ptr: 16, 8, 4, or kShiftedLoad
__host__ __device__ inline int bf16_copy_width(const void* ptr, int d) {
  const uintptr_t a = (uintptr_t)ptr;
  for (int w = kWidestCopy; w >= kNarrowestCopy; w /= 2)
    if (a % w == 0 && (2 * d) % w == 0) return w;
  return kShiftedLoad;
}

// One cp.async of kBytes (4, 8 or 16), of which the first src_bytes are
// read (none where 0) and the rest zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"(kBytes), "r"(src_bytes));
}

// Values e..e+7 of the 16 values lo:hi (two 16-byte words), e in 0..7
__device__ __forceinline__ uint4 shift8(uint4 lo, uint4 hi, int e) {
  uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int words = e >> 1;
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = words & 2 ? x[i + 2] : x[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = words & 1 ? x[i + 1] : x[i];
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = e & 1 ? __funnelshift_r(x[i], x[i + 1], 16) : x[i];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// v with its values from `left` on set to zero
__device__ __forceinline__ uint4 keep_first(uint4 v, int left) {
  uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] &= (2 * i < left ? 0xffffu : 0u) | (2 * i + 1 < left ? 0xffff0000u : 0u);
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// The 8 values of a row at src on, zero from the row's value `left` on
// (left >= 1), from the aligned 16-byte words that cover them
__device__ __forceinline__ uint4 shifted_load8(const __nv_bfloat16* src, int left) {
  const uintptr_t a = (uintptr_t)src;
  const uint4* w = reinterpret_cast<const uint4*>(a & ~(uintptr_t)15);
  const int e = (int)(a & 15) >> 1;  // values of the first word before src
  const uint4 lo = __ldg(w);
  const uint4 hi = e > 0 && left > 8 - e ? __ldg(w + 1) : make_uint4(0u, 0u, 0u, 0u);
  return keep_first(shift8(lo, hi, e), left);
}

// 8 values of a row into the 16 bytes at dst: those from src on, zero from
// the row's value `left` on (all zero where left <= 0), by copies of
// `width` bytes (kAnyWidth false: 16) or a shifted load; `any` is a
// pointer of the tensor that a copy reading nothing may name
template <bool kAnyWidth>
__device__ __forceinline__ void copy8_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int left, int width, const __nv_bfloat16* any) {
  if (!kAnyWidth || width == 16) {
    cp_async_zfill<16>(dst, left > 0 ? src : any, left > 0 ? 16 : 0);
  } else if (width == 8) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = min(8, max(0, 2 * (left - 4 * j)));
      cp_async_zfill<8>(dst + 4 * j, n ? src + 4 * j : any, n);
    }
  } else if (width == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = min(4, max(0, 2 * (left - 2 * j)));
      cp_async_zfill<4>(dst + 2 * j, n ? src + 2 * j : any, n);
    }
  } else {
    *reinterpret_cast<uint4*>(dst) =
        left > 0 ? shifted_load8(src, left) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Row r (of `rows`) of a tile of output rows in shared memory (o_s, rows
// P values apart, 16-byte aligned) to ob (rows ld values apart), its first
// `cols` values: the 16-byte words of the destination row that lie wholly
// in it take one 16-byte store each (of the tile's values shifted by the
// row's offset in its word), the partial words at its ends one 2-byte store
// a value.  The threads of `threads` (from `tid`) share the rows' words.
__device__ __forceinline__ void store_rows_any_bf16(const __nv_bfloat16* o_s, int P,
                                                    __nv_bfloat16* ob, size_t ld, int rows,
                                                    int cols, int words, int tid,
                                                    int threads) {
  for (int i = tid; i < rows * words; i += threads) {
    const int r = i / words, m = i - r * words;
    __nv_bfloat16* row = ob + (size_t)r * ld;
    const int e = (int)((uintptr_t)row & 15) >> 1;  // the row's offset in its 16-byte word
    const int c0 = 8 * m - e;                        // the word's first column
    if (c0 >= cols) continue;
    const uint4* src = reinterpret_cast<const uint4*>(o_s + r * P);
    const uint4 hi = src[m];
    const uint4 val = e ? shift8(m > 0 ? src[m - 1] : make_uint4(0u, 0u, 0u, 0u), hi, 8 - e) : hi;
    if (c0 >= 0 && c0 + 8 <= cols) {
      *reinterpret_cast<uint4*>(row + c0) = val;
    } else {
      const uint32_t x[4] = {val.x, val.y, val.z, val.w};
      unsigned short* out = reinterpret_cast<unsigned short*>(row);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j >= 0 && c0 + j < cols)
          out[c0 + j] = (unsigned short)(x[j >> 1] >> (16 * (j & 1)));
    }
  }
}

// S > 128, or (kFill) any other bf16 call up to d = 128: the keys streamed
// through a ring of kStages key blocks of 16·KC keys (the kBf16 constants
// above).  D: d_k = d_v, or with kFill max(d_k, d_v) rounded up to 16.
// kFill takes any d_k and d_v and pointers aligned only to 2 bytes, zero
// past d_k (Q, K) and d_v (V), so the columns past d_k add nothing to q·kᵀ
// and those past d_v give outputs that are not stored.  What bounded it
// (its first design, one synchronous 2-byte load a value and one store
// a value: 0.1340 ms at d = 72, S = 64, h = 4, N = 200, 3.1× SDPA's time,
// against 0.018 ms for its bytes at 3.35 TB/s) was its copies: no copy was
// in flight while the warps multiplied.  Now each of q, k and v goes into
// the ring by the widest cp.async its pointer and d allow, 16, 8 or 4
// bytes, the source size cut at d to zero-fill the rest (bf16_copy_width,
// copy8_bf16; 16 bytes at d = 72), so the copies overlap the products as
// in the aligned instances; for a tensor aligned only to 2 bytes (or odd
// d) the aligned 16-byte words that cover each row are copied by cp.async
// too, as they lie, into the row of the tile, and shifted into place there
// a step before the key block's own (the Q tile and key block 0 before the
// first step), the ring a stage longer so that two key blocks stay in
// flight; and the output goes
// through the warp's rows of the Q tile to leave in 16-byte stores
// wherever whole 16-byte words of a row lie (store_rows_any_bf16).  The
// products, the online softmax and both modes of p are the aligned
// instances'; those instances (every HCM call) compile to the same code as
// before (scripts/attention_ab.py compares their SASS).  kWarps warps a block,
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
  constexpr int KC = kBf16KeyChunks, kWarps = kBf16BlockWarps;
  constexpr int kStages = kFill ? kBf16FillStages : kBf16Stages;
  constexpr int P = D + kPad;         // row pitch of the shared tiles, in values
  constexpr int kChunks = D / 8;      // 16-byte chunks in one head's row
  constexpr int kTile = 16 * kWarps;  // query rows of a block
  constexpr int kKeys = 16 * KC;      // keys of a key block
  constexpr int kThreads = kWarps * 32;
  constexpr int kItems = kKeys * kChunks;  // 16-byte copies of K (and of V) a key block
  constexpr int kRounds = (kItems + kThreads - 1) / kThreads;  // of them a thread
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
  // kFill: the copy width of each of q, k and v (bf16_copy_width)
  const int wq = kFill ? bf16_copy_width(q, dk) : 16;
  const int wk = kFill ? bf16_copy_width(k, dk) : 16;
  const int wv = kFill ? bf16_copy_width(v, dv) : 16;
  // kFill, a tensor whose rows no cp.async can take (bf16_copy_width 0):
  // the aligned 16-byte words that cover each of its rows are copied as
  // they lie, by cp.async, into the row of its tile (D/8 + 1 words, the
  // tile's pitch), and once every thread's have landed shift_rows shifts
  // each row into place there, two threads of a warp a row, each taking
  // half its words: 4-byte reads at the row's offset and a funnel shift by
  // its odd value, no select (the first half reads its last word before
  // the second half overwrites it)
  auto copy_words = [&](__nv_bfloat16* tile, const __nv_bfloat16* base, size_t ld,
                        int valid_rows, int rows_n, int d, const __nv_bfloat16* any) {
    const uintptr_t none = (uintptr_t)any & ~(uintptr_t)15;
#pragma unroll 1
    for (int j = 0; j < (kTile * (kChunks + 1) + kThreads - 1) / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x, r = i / (kChunks + 1), m = i % (kChunks + 1);
      if (r >= rows_n) break;
      const uintptr_t a = (uintptr_t)(base + (size_t)r * ld);
      const uintptr_t w = (a & ~(uintptr_t)15) + 16 * m;  // never past the row's last word
      const bool ok = r < valid_rows && w <= ((a + 2 * (d - 1)) & ~(uintptr_t)15);
      cp_async16(tile + r * P + 8 * m, (const void*)(ok ? w : none), ok);
    }
  };
  auto shift_rows = [&](__nv_bfloat16* tile, const __nv_bfloat16* base, size_t ld, int rows_n,
                        int d, int first_thread) {
    constexpr int kHalf = kChunks / 2;  // 16-byte words a thread writes (D/8 is even)
    const int t = (int)threadIdx.x - first_thread, r = t >> 1, h = t & 1;
    const bool mine = t >= 0 && r < rows_n;
    uint32_t* row = reinterpret_cast<uint32_t*>(tile + r * P) + 4 * h * kHalf;
    int words = 0, bits = 0;  // the row's offset in its 16-byte word: 4-byte words, then odd
    uint32_t last[5];         // the 4-byte words of this half's last output
    if (mine) {
      const int e = (int)((uintptr_t)(base + (size_t)r * ld) & 15) >> 1;
      words = e >> 1;
      bits = 16 * (e & 1);
#pragma unroll
      for (int j = 0; j < 5; ++j) last[j] = row[4 * (kHalf - 1) + words + j];
    }
    __syncwarp();
    if (mine) {
      uint32_t x = row[words];
#pragma unroll 1
      for (int m = 0; m < kHalf; ++m) {
        uint32_t y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t next = m + 1 < kHalf ? row[4 * m + words + j + 1] : last[j + 1];
          y[j] = __funnelshift_r(m + 1 < kHalf ? x : last[j], next, bits);
          x = next;
        }
        const int left = d - 8 * (h * kHalf + m);
        uint4 v = make_uint4(y[0], y[1], y[2], y[3]);
        if (left < 8) v = keep_first(v, left);
        reinterpret_cast<uint4*>(row)[m] = v;
      }
    }
  };
  if constexpr (kFill) {
#pragma unroll
    for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (wq)
        copy8_bf16<true>(q_s + r * P + c, qb + (size_t)r * heads * dk + c,
                         q0 + r < Lq ? dk - c : 0, wq, q);
    }
    if (!wq) copy_words(q_s, qb, (size_t)heads * dk, Lq - q0, kTile, dk, q);
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
  // d_k and d_v; a shifted tensor's words as they lie)
  auto copy_block = [&](int blk) {
    __nv_bfloat16* k_s = ring + (blk % kStages) * 2 * kKeys * P;
    __nv_bfloat16* v_s = k_s + kKeys * P;
    const int s0 = blk * kKeys;
    if constexpr (kFill) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {  // K, then V
        const int w = t ? wv : wk, d = t ? dv : dk;
        __nv_bfloat16* tile = t ? v_s : k_s;
        const __nv_bfloat16* base = (t ? vb : kb) + (size_t)s0 * heads * d;
        if (!w) {
          copy_words(tile, base, (size_t)heads * d, S - s0, kKeys, d, t ? v : k);
          continue;
        }
#pragma unroll
        for (int j = 0; j < kRounds; ++j) {
          const int i = j * kThreads + threadIdx.x;
          if (kItems % kThreads == 0 || i < kItems) {
            const int r = i / kChunks, c = (i % kChunks) * 8;
            copy8_bf16<true>(tile + r * P + c, base + (size_t)r * heads * d + c,
                             s0 + r < S ? d - c : 0, w, t ? v : k);
          }
        }
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
  // kFill with a shifted tensor: key block blk's rows of it shifted into
  // place (K's by the first 2·kKeys threads, V's by the next), once every
  // thread's words of it have landed.  Each key block past the first is
  // shifted at the step before its own, so no step waits on a second
  // barrier; the fill instance's ring has a stage more than the aligned
  // instances', so two key blocks' copies are in flight while a shifted
  // one is multiplied (and three while an aligned one is).
  const bool shifted = kFill && (!wq || !wk || !wv);
  auto shift_block = [&](int blk) {
    __nv_bfloat16* k_s = ring + (blk % kStages) * 2 * kKeys * P;
    if (!wk)
      shift_rows(k_s, kb + (size_t)blk * kKeys * heads * dk, (size_t)heads * dk, kKeys, dk, 0);
    if (!wv)
      shift_rows(k_s + kKeys * P, vb + (size_t)blk * kKeys * heads * dv, (size_t)heads * dv,
                 kKeys, dv, 2 * kKeys);
  };
#pragma unroll
  for (int blk = 0; blk < kStages - 1; ++blk) {  // the Q tile goes with key block 0
    if (blk < n_blocks) copy_block(blk);
    cp_async_commit();
  }
  if (shifted) {  // the Q tile and key block 0 shifted before the first step
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (!wq) shift_rows(q_s, qb, (size_t)heads * dk, kTile, dk, 0);
    shift_block(0);
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
    // this thread's copies of key block blk (shifted: and blk + 1) have landed
    if (shifted)
      cp_async_wait<kStages - 3>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();  // every thread's have; no warp reads the stage refilled next
    if (shifted && blk + 1 < n_blocks) shift_block(blk + 1);
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
  if constexpr (kFill) {
    // the warp's rows through its own rows of the Q tile, then the columns
    // below d_v in the widest stores the output rows' alignment allows
    __nv_bfloat16* o_s = q_s + row0 * P;
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
    store_rows_any_bf16(o_s, P, out + ((size_t)n * Lq + q0 + row0) * heads * dv + head * dv,
                        (size_t)heads * dv, min(16, rows - row0), dv, kChunks + 1, lane, 32);
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
  constexpr size_t smem = bf16_blocks_smem_bytes(D, kFill);
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

// 8-key chunks of one key block: 32 keys (see the note at the top)
constexpr int kF32KeyChunks = 4;

// S > 128 at D = 32 and 64 (D = 128 and 256 take the warpgroup-MMA kernel
// below): the keys streamed in key blocks of 8·KC with an online softmax.
// D: d_k and d_v rounded up to 32 or 64; kNarrow: the copy width, as above.  The query tiles, warps,
// fragments and split layouts are those of cross_modal_attn_f32tc_kernel;
// the tiles are zero past Lq, S, d_k and d_v.  Every warp copies and
// splits, and meets the barriers, including a warp with no query rows in
// a partial tile, which multiplies nothing.  Its register budget allows 16
// more a thread than the kernel above (the running max and sums and the
// copy's addresses live across the key-block loop; at 40, D = 32 spilled).
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
  constexpr int KC = kF32KeyChunks;
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

// D = 128 and 256, past S = 128 and at every S at D = 256: the keys streamed
// in key blocks on warpgroup MMA (cross_modal_attn_f32wg_blocks_kernel,
// below)
template <int D, bool kNarrow>
int launch_f32wg_blocks(const void* q, const void* k, const void* v, void* out, int N,
                        int Lq, int S, int heads, int dk, int dv, cudaStream_t stream);

// The keys whole (S <= 128, D <= 128) or, where key_blocks, streamed in
// key blocks (any S); D = 256 only in key blocks.
template <int D, bool kNarrow>
int launch_f32tc(const void* q, const void* k, const void* v, void* out, int N,
                 int Lq, int S, int heads, int dk, int dv, bool key_blocks,
                 cudaStream_t s) {
  if (key_blocks) {
    if constexpr (D >= 128)
      return launch_f32wg_blocks<D, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
    else
      return launch_f32tc_blocks<D, kNarrow>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  }
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

constexpr int kWideTile = 64;   // query rows of a float32 block: its consumer warpgroup's
constexpr int kWideDk = 272;    // the most d_k columns a block holds; past it, chunks of 272
constexpr int kWideHalf = 136;  // the most d_v columns of a float32 wgmma N tile; two a slice

// Slices of d_v, one block each: ceil(d_v / 272), each of width a multiple
// of 8 (one slice, so one pass over d_v, up to d_v = 272)
__host__ __device__ constexpr int wide_slices(int dv) {
  return (dv + 2 * kWideHalf - 1) / (2 * kWideHalf);
}

__host__ __device__ constexpr int wide_width(int dv) {
  return ((dv + wide_slices(dv) - 1) / wide_slices(dv) + 7) / 8 * 8;
}

// ------------------------------------------ wide heads, bfloat16

constexpr int kWideBf16Warps = 8;  // 16 query rows each, every column of the slice
constexpr int kWideBf16Threads = kWideBf16Warps * 32;
constexpr int kWideBf16Tile = 128;  // query rows of a block
static_assert(kWideBf16Tile == 16 * kWideBf16Warps, "16 query rows a warp");
constexpr int kWideBf16Keys = 32;    // keys of a key block: two 16-key chunks
constexpr int kWideBf16Stages = 4;   // key blocks (K and V) in the ring
constexpr int kWideBf16Pitch = kWideDk + 8;  // values a row of the Q, K and V tiles

// Shared memory of one block of cross_modal_attn_wide_bf16_kernel: the Q
// tile and the ring's stages of K and V, in rows of kWideBf16Pitch values,
// whatever the sizes.
__host__ __device__ constexpr size_t wide_bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * kWideBf16Pitch *
         (kWideBf16Tile + 2 * kWideBf16Stages * kWideBf16Keys);
}

// bfloat16 heads past 128 (d_k or d_v), any S, d_k, d_v and alignment.
// Replaces the first design of the wide kernel (tf32 mma.sync on bf16
// bits, one block a d_v slice of up to 128 columns, d_k streamed in chunks
// of 32 with a barrier each, one value a load where unaligned: 0.4468 ms at
// d = 256, h = 2, S = 200, N = 200, Lq = 200, 6.2× SDPA's time, and 1.83 ms
// at d = 260).  What bounds the work: bytes (44 MB a call at that shape,
// 0.049 ms at 3.35 TB/s, against 0.017 ms for its bf16 products at 989
// TFLOP/s; at phase 14's window, h = 1 and S = 16 and 64, 0.029 ms for both
// calls).  What held the first designs back on the card was the rate at
// which a block's copies arrive: each query tile copies its head's K and V
// again, from L2 (at 64-row tiles four times at Lq = 200, 270 KB a block),
// and a block with one key block in flight took about 18 KB/µs an SM
// whatever its arithmetic (0.2008 and 0.2238 ms at d = 256, h = 2, S =
// 200 with 64-row tiles, PERF.md).  The design: one block of 8 warps per
// (example, head, 128-query tile, d_v slice), slice fastest, then tile, so
// a head's blocks run side by side and find its K and V in L2, and K and V
// are copied twice a head at Lq = 200; d_v up to 272 is one slice, so one
// pass, and the Q tile is copied from device memory once a block, d_k
// whole up to 272.  Each warp takes 16 query rows and every column of the
// slice (136 accumulators a thread), so no warp computes a logit that
// another computes too.  Both products are bf16 mma.sync m16n8k16 from
// ldmatrix (.trans for V) fragments, exact in the float32 accumulator as in
// the other bf16 kernels.  The keys stream in key blocks of 32 through a
// ring of kWideBf16Stages stages of K and V (each row whole), one barrier a
// key block, the next three key blocks' copies in flight while the warps
// multiply one; shared memory is 215,040 bytes whatever the sizes, one
// block an SM.  The products run over all 272 columns of the tiles, zero
// past d_k and the slice, so their loops take no branch (with a runtime
// bound on them, and an eager max, the call took 0.2103 ms; PERF.md).  The
// online softmax is the bf16 key-block kernel's (a lazy
// reference max, base 2, one FMA before ex2.approx); p against the
// reference goes into p·v rounded to bf16 once (kRoundP) or split into
// p_hi + p_lo, two bf16 products, 16 bits of p (the first design kept 21 in
// tf32), as the bf16 key-block kernel; the output is divided by the float32
// sum at the end, staged through the warp's rows of the Q tile and stored
// in 16-byte words.  Copies are 16-byte cp.async; with kNarrow (pointers or
// d off a multiple of 8) each of q, k and v takes the widest cp.async its
// pointer and d allow (bf16_copy_width: 8 bytes at d = 260), or shifted
// loads (copy8_bf16).  Past d_k = 272 the block copies d_k in chunks of 272
// with the key block's K, both waited for before each chunk's product.
template <bool kRoundP, bool kNarrow>
__global__ void __launch_bounds__(kWideBf16Threads, 1)
cross_modal_attn_wide_bf16_kernel(const __nv_bfloat16* __restrict__ q,  // (N, Lq, h*dk)
                                  const __nv_bfloat16* __restrict__ k,  // (N, S, h*dk)
                                  const __nv_bfloat16* __restrict__ v,  // (N, S, h*dv)
                                  __nv_bfloat16* __restrict__ out,      // (N, Lq, h*dv)
                                  int Lq, int S, int heads, int dk, int dv, int tiles,
                                  int slices, int width, float scale) {
  constexpr int P = kWideBf16Pitch, KB = kWideBf16Keys, kThreads = kWideBf16Threads;
  constexpr int kTile = kWideBf16Tile, kStages = kWideBf16Stages;
  constexpr int kChunks = kWideDk / 8;       // 16-byte chunks of a row of a tile
  constexpr int kQItems = kTile * kChunks;
  constexpr int kKItems = KB * kChunks;
  constexpr int kNT = 2 * kWideHalf / 8;     // n-tiles of a slice
  constexpr int kStageBytes = 2 * KB * P * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kTile, P)
  __nv_bfloat16* ring = q_s + kTile * P;  // kStages × (K (KB, P), V (KB, P))

  int b = blockIdx.x;
  const int slice = b % slices;
  b /= slices;
  const int tile = b % tiles, nh = b / tiles;  // nh = n * heads + head
  const int n = nh / heads, head = nh - n * heads;
  const int q0 = tile * kTile, c0 = slice * width;  // first query row, first d_v column
  const int cols = min(width, dv - c0);              // d_v columns of this block
  const int ldk = heads * dk, ldv = heads * dv;
  const __nv_bfloat16* qb = q + ((size_t)n * Lq + q0) * ldk + head * dk;
  const __nv_bfloat16* kb = k + (size_t)n * S * ldk + head * dk;
  const __nv_bfloat16* vb = v + (size_t)n * S * ldv + head * dv + c0;
  const int wq = kNarrow ? bf16_copy_width(q, dk) : 16;
  const int wk = kNarrow ? bf16_copy_width(k, dk) : 16;
  const int wv = kNarrow ? bf16_copy_width(v, dv) : 16;
  const int n_chunks = (dk + kWideDk - 1) / kWideDk;  // of d_k
  const int n_blocks = (S + KB - 1) / KB;

  // Q's columns d0..d0 + 271, zero past d_k and Lq
  auto copy_q = [&](int d0) {
#pragma unroll 1
    for (int j = 0; j < (kQItems + kThreads - 1) / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (kQItems % kThreads == 0 || i < kQItems) {
        const int r = i / kChunks, c = (i % kChunks) * 8;
        copy8_bf16<kNarrow>(q_s + r * P + c, qb + (size_t)r * ldk + d0 + c,
                            q0 + r < Lq ? dk - d0 - c : 0, wq, q);
      }
    }
  };
  // key block blk's K (columns d0..d0 + 271) and, with_v, its V (the
  // slice's columns) into ring stage `stage`, zero past S, d_k and the slice
  auto copy_kv = [&](int blk, int d0, bool with_v, int stage) {
    __nv_bfloat16* k_s = ring + stage * 2 * KB * P;
    __nv_bfloat16* v_s = k_s + KB * P;
#pragma unroll 1
    for (int j = 0; j < (kKItems + kThreads - 1) / kThreads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (kKItems % kThreads == 0 || i < kKItems) {
        const int r = i / kChunks, c = (i % kChunks) * 8;
        const int key = blk * KB + r;
        const bool ok = key < S;
        copy8_bf16<kNarrow>(k_s + r * P + c, kb + (size_t)key * ldk + d0 + c,
                            ok ? dk - d0 - c : 0, wk, k);
        if (with_v)
          copy8_bf16<kNarrow>(v_s + r * P + c, vb + (size_t)key * ldv + c, ok ? cols - c : 0,
                              wv, v);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int rows = min(kTile, Lq - q0);
  const bool busy = row0 < rows;
  const float scale2 = scale * 1.4426950408889634f;
  // shared-memory addresses of the lane's ldmatrix rows (as in the bf16
  // key-block kernel): its A rows of the Q tile, its B rows of K, its B
  // rows of V (transposed); every other offset is a constant
  const uint32_t q_lane = (uint32_t)__cvta_generic_to_shared(q_s) +
                          2 * ((row0 + (lane & 15)) * P + (lane >> 4) * 8);
  const uint32_t k_lane = (uint32_t)__cvta_generic_to_shared(ring) +
                          2 * (((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = (uint32_t)__cvta_generic_to_shared(ring) + 2 * KB * P +
                          2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
  float o_acc[kNT][4];  // o_acc[t]: columns 8t..8t+7 of the slice
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[t][e] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY};  // the rows' reference max (scaled, base 2)
  float sum[2] = {0.0f, 0.0f};           // the lane's share of the row sum

  // the key block's logits over all 272 columns of the Q and K tiles (zero
  // past d_k, so the products take no branch): s[t] holds keys 8t..8t+7,
  // rows lane/4 and lane/4 + 8
  auto logits = [&](float (&s)[KB / 8][4], uint32_t k_at) {
#pragma unroll
    for (int ks = 0; ks < kWideDk / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, q_lane + 32 * ks);
#pragma unroll
      for (int c = 0; c < KB / 16; ++c) {
        uint32_t bk[4];  // b0, b1 of keys 16c..+7, then of the next 8
        ldmatrix_x4(bk, k_at + 2 * 16 * c * P + 32 * ks);
        mma_bf16(s[2 * c], a, bk[0], bk[1]);
        mma_bf16(s[2 * c + 1], a, bk[2], bk[3]);
      }
    }
  };
  // the online softmax of one key block, then p·v over all 272 columns of
  // the V tile (zero past the slice's); only the last key block (last:
  // std::true_type) has keys past S, from `valid` on.  The softmax is the
  // bf16 key-block kernel's: a row's reference max moves only when the key
  // block's max passes it by more than kBf16MaxSlack, so the output and the
  // sum are rescaled only then, and p = 2^(logit·scale - max) is one FMA
  // before ex2.approx.
  auto attend = [&](auto last, float (&s)[KB / 8][4], uint32_t v_at, int valid) {
    constexpr bool kLast = decltype(last)::value;
    if constexpr (kLast) {
#pragma unroll
      for (int t = 0; t < KB / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * t + 2 * (lane & 3) + (e & 1) >= valid) s[t][e] = -INFINITY;
    }
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < KB / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s[t][e]);
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
        for (int t = 0; t < kNT; ++t) {
          o_acc[t][2 * h] *= alpha;
          o_acc[t][2 * h + 1] *= alpha;
        }
        mx[h] = m;
      }
    }
#pragma unroll
    for (int t = 0; t < KB / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = ex2(fmaf(s[t][e], scale2, -mx[e >> 1]));
        sum[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int c = 0; c < KB / 16; ++c) {
      if (!kLast || 16 * c < valid) {  // a chunk wholly past S adds nothing
        uint32_t hi[4], lo[4];  // the A fragment of keys 16c..+15: n-tiles 2c, 2c + 1
        p_pack<kRoundP>(s[2 * c][0], s[2 * c][1], hi[0], lo[0]);
        p_pack<kRoundP>(s[2 * c][2], s[2 * c][3], hi[1], lo[1]);
        p_pack<kRoundP>(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo[2]);
        p_pack<kRoundP>(s[2 * c + 1][2], s[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          uint32_t bv[4];  // b0, b1 of columns 16j..+7, then of 16j+8..+15
          ldmatrix_x4_trans(bv, v_at + 2 * (16 * c * P + 16 * j));
          p_times_v<kRoundP>(o_acc[2 * j], hi, lo, bv[0], bv[1]);
          p_times_v<kRoundP>(o_acc[2 * j + 1], hi, lo, bv[2], bv[3]);
        }
      }
    }
  };
  // key block blk's softmax and p·v, the last one's keys past S masked
  auto attend_block = [&](float (&s)[KB / 8][4], uint32_t v_at, int blk) {
    if (blk + 1 < n_blocks)
      attend(std::false_type{}, s, v_at, KB);
    else
      attend(std::true_type{}, s, v_at, S - blk * KB);
  };

  if (n_chunks == 1) {
    // d_k whole: the Q tile once, the key blocks through the ring, the
    // first kStages - 1 with it, one commit group each
    copy_q(0);
#pragma unroll
    for (int blk = 0; blk < kStages - 1; ++blk) {
      if (blk < n_blocks) copy_kv(blk, 0, true, blk);
      cp_async_commit();
    }
    for (int blk = 0; blk < n_blocks; ++blk) {
      cp_async_wait<kStages - 2>();  // this thread's copies of key block blk have landed
      __syncthreads();  // every thread's have; no warp reads the stage refilled next
      if (blk + kStages - 1 < n_blocks)
        copy_kv(blk + kStages - 1, 0, true, (blk + kStages - 1) % kStages);
      cp_async_commit();  // empty past the last key block, to keep the count
      if (!busy) continue;
      const int stage = blk % kStages;
      float s[KB / 8][4] = {};
      logits(s, k_lane + stage * kStageBytes);
      attend_block(s, v_lane + stage * kStageBytes, blk);
    }
  } else {
    // d_k past 272: each key block's chunks of Q and K copied in turn into
    // the first stage and waited for
    for (int blk = 0; blk < n_blocks; ++blk) {
      float s[KB / 8][4] = {};
      for (int ch = 0; ch < n_chunks; ++ch) {
        __syncthreads();  // no warp still reads the chunk before (or the V before)
        copy_q(ch * kWideDk);
        copy_kv(blk, ch * kWideDk, ch == 0, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (busy) logits(s, k_lane);
      }
      if (busy) attend_block(s, v_lane, blk);
    }
  }

  // the warp's rows through its own rows of the Q tile (no other warp reads
  // them), then out in 16-byte words
  if (!busy) return;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const float inv = 1.0f / sum[h];
    __nv_bfloat16* o_s = q_s + (row0 + g + 8 * h) * P + cq;
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      if (8 * t < cols)
        *reinterpret_cast<__nv_bfloat162*>(o_s + 8 * t) =
            __floats2bfloat162_rn(o_acc[t][2 * h] * inv, o_acc[t][2 * h + 1] * inv);
  }
  __syncwarp();
  store_rows_any_bf16(q_s + row0 * P, P,
                      out + ((size_t)n * Lq + q0 + row0) * ldv + head * dv + c0, ldv,
                      min(16, rows - row0), cols, kChunks + 1, lane, 32);
}

template <bool kRoundP, bool kNarrow>
int launch_wide_bf16_as(const void* q, const void* k, const void* v, void* out, int N, int Lq,
                        int S, int heads, int dk, int dv, cudaStream_t stream) {
  static SmemOptIn opt_in;
  constexpr size_t smem = wide_bf16_smem_bytes();
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_wide_bf16_kernel<kRoundP, kNarrow>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kWideBf16Tile - 1) / kWideBf16Tile, slices = wide_slices(dv);
  const long long blocks = (long long)N * heads * tiles * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_wide_bf16_kernel<kRoundP, kNarrow>
      <<<(unsigned)blocks, kWideBf16Threads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Lq, S, heads,
          dk, dv, tiles, slices, wide_width(dv), 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

// d += a·b on a 64 × 16 × 8 tile: wgmma, tf32 A and B from shared memory
// (descriptors), float32 accumulators d[4i + e] at row 16·warp + lane/4 +
// 8(e / 2), column 8i + 2(lane % 4) + e % 2 of the warpgroup's 64 rows
__device__ __forceinline__ void wgmma_n16_ss(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// d += a·b on a 64 × 136 × 8 tile: wgmma, tf32 A from registers (a0 row
// lane/4, column lane % 4 of the warp's 16 rows; a1 8 rows on; a2, a3 4
// columns on), B from shared memory, accumulators as wgmma_n16_ss's
__device__ __forceinline__ void wgmma_n136_rs(float (&d)[68], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67"
      "}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
      "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a·b on a 64 × 32 × 8 tile: A and B from shared memory (descriptors),
// accumulators as wgmma_n16_ss's
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d += a·b on a 64 × 128 × 8 tile: A from registers (as wgmma_n136_rs's),
// B from shared memory
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------ wide heads, float32 on wgmma

constexpr int kWgKeys = 16;  // keys of a key block
constexpr int kWgThreads = 256;  // a consumer warpgroup (64 query rows) and a producer warpgroup
constexpr int kWgVRows = 2 * kWideHalf;  // rows of Vᵀ: the slice's d_v in two N tiles of 136

// Shared memory of one block of cross_modal_attn_wide_f32_kernel: Q's hi
// and lo parts (64 rows of kWideDk), K's (kWgKeys rows of kWideDk) and
// Vᵀ's (kWgVRows rows of kWgKeys), in floats, and six mbarriers, whatever
// the sizes.
__host__ __device__ constexpr size_t wide_f32_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kWideTile * kWideDk + 2 * (size_t)kWgKeys * kWideDk +
                          2 * (size_t)kWgVRows * kWgKeys) +
         6 * sizeof(uint64_t);
}

// The float at row r, column c of a K-major tile of kw columns as wgmma
// reads it without swizzle: core matrices of 8 rows × 4 floats (128
// contiguous bytes, rows 16 bytes apart), those along K 128 bytes apart,
// the next 8 rows 32·kw bytes on
__device__ __forceinline__ int core_index(int r, int c, int kw) {
  return (r >> 3) * 8 * kw + (c >> 2) * 32 + (r & 7) * 4 + (c & 3);
}

// A wgmma operand descriptor of such a tile at shared-memory byte address
// `addr`: leading (K) offset 128 bytes, stride (8 rows) offset `sbo`, no
// swizzle
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers that a wgmma wrote, fenced so that no read of them moves above
// the wait
template <int kN>
__device__ __forceinline__ void fence_registers(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  The loop
// is inside the asm (its labels local to the braces), so the compiler sees
// no branch on a thread's own value around a warpgroup's wgmma, which it
// would otherwise serialize.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The producer's writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 floats of a row into the 16 bytes at dst, zero from the row's value
// `left` on: one 16-byte cp.async, or (kNarrow) four of 4 bytes
template <bool kNarrow>
__device__ __forceinline__ void copy4_f32(float* dst, const float* src, int left,
                                          const float* any) {
  if constexpr (!kNarrow) {
    cp_async16(dst, left > 0 ? src : any, left > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < left ? src + e : any, e < left);
  }
}

// 4 floats of a row at src, zero from the row's value `left` on: one
// 16-byte load, or (kNarrow) four of 4 bytes
template <bool kNarrow>
__device__ __forceinline__ float4 load4_f32(const float* src, int left) {
  if constexpr (!kNarrow) {
    return left > 0 ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0, 0, 0, 0);
  } else {
    return make_float4(left > 0 ? __ldg(src) : 0.0f, left > 1 ? __ldg(src + 1) : 0.0f,
                       left > 2 ? __ldg(src + 2) : 0.0f, left > 3 ? __ldg(src + 3) : 0.0f);
  }
}

// x split into tf32 hi and lo, stored as 16 bytes each at hi and lo
__device__ __forceinline__ void split4_store(float4 x, float* hi, float* lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The 16 bytes at raw split in place into tf32 lo, their hi parts to hi
__device__ __forceinline__ void split4_in_place(float* raw, float* hi) {
  const float4 x = *reinterpret_cast<const float4*>(raw);
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(raw) = make_uint4(l[0], l[1], l[2], l[3]);
}

// float32 heads past 256 (d_k or d_v), any S, d_k, d_v and alignment.
// Replaces the first design of the wide kernel in float32 (3xTF32 on
// mma.sync, each of 4 warps splitting every K and V value it read, one
// block a d_v slice of up to 128 columns, so the logits three times at d_v
// = 260: 1.6497 ms at d = 260, h = 2, S = 200, N = 200, Lq = 200, 2.3×
// SDPA's time).  What bounds it: operations, three tf32 products (0.10 ms
// at 495 TFLOP/s; its bytes take about as long at 3.35 TB/s), and
// mma.sync, measured at about 81 TFLOP/s on the H100, does not reach that
// rate; warpgroup MMA (wgmma) does.  The design: one block per (example,
// head, 64-query tile, d_v slice of up to 272), slice fastest, then tile,
// of two warpgroups.  The consumer warpgroup owns the 64 query rows: q·kᵀ
// as wgmma m64n16k8 with A (Q) and B (K) from shared memory, 3xTF32 per
// k-step (q_lo·k_hi, q_hi·k_lo, then q_hi·k_hi, the other tf32 kernels'
// order), over 16-key blocks; the online softmax of the float32 key
// blocks in its accumulators; p·v as wgmma m64n136k8 with p's hi and lo
// parts as A from registers (the logits' accumulator layout is p's A layout
// once the keys of each 8 are taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
// which Vᵀ is written in) and Vᵀ from shared memory, two N tiles of 136
// for the slice's d_v in one pass (136 accumulators a thread).  wgmma reads
// tf32 operands K-major from shared memory and cannot split them as it
// reads, so the producer warpgroup stages every tile split: Q once a block
// (hi and lo, 139,264 bytes at 64 × 272, copied by cp.async and split in
// place), each key block's K (hi and lo) and V transposed (Vᵀ hi and lo),
// so each value is split once for the warpgroup's 64 rows.  One K and one
// Vᵀ stage fit beside Q (208,944 bytes, one block an SM), so the two
// alternate: the producer fills K while the consumer multiplies p·v, and
// Vᵀ while it multiplies q·kᵀ, each stage handed over by a full and an
// empty mbarrier; the next K and V are loaded into the producer's
// registers (16-byte loads, or 4 with kNarrow) as soon as the stage before
// is stored, so their loads are in flight while the consumer multiplies
// and only the split and the stores wait for the stage (copying K by
// cp.async only once its stage was free, the call took 1.2149 ms, with
// its wgmma serialized; PERF.md).  With one consumer warpgroup, every warp can hold 255
// registers, so no setmaxnreg is needed.  Past d_k = 272 the producer
// stages Q in chunks of 272 beside K's, for every key block, through a Q
// barrier pair.
template <bool kNarrow>
__global__ void __launch_bounds__(kWgThreads, 1)
cross_modal_attn_wide_f32_kernel(const float* __restrict__ q,  // (N, Lq, h*dk)
                                 const float* __restrict__ k,  // (N, S, h*dk)
                                 const float* __restrict__ v,  // (N, S, h*dv)
                                 float* __restrict__ out,      // (N, Lq, h*dv)
                                 int Lq, int S, int heads, int dk, int dv, int tiles,
                                 int slices, int width, float scale) {
  constexpr int KB = kWgKeys, kQRow = kWideDk / 4;  // 16-byte items of a Q or K row
  constexpr int kQItems = kWideTile * kQRow, kKItems = KB * kQRow;
  constexpr int kVItems = 4 * (kWgVRows / 4);  // (8-key group, parity, 4 columns)
  constexpr uint32_t kSboQK = 32 * kWideDk, kSboV = 32 * KB;  // bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_hi = reinterpret_cast<float*>(smem_raw);   // (64, kWideDk), core order
  float* q_lo = q_hi + kWideTile * kWideDk;
  float* k_hi = q_lo + kWideTile * kWideDk;           // (KB, kWideDk), core order
  float* k_lo = k_hi + KB * kWideDk;
  float* vt_hi = k_lo + KB * kWideDk;                 // (kWgVRows, KB), core order
  float* vt_lo = vt_hi + kWgVRows * KB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vt_lo + kWgVRows * KB);
  uint64_t *q_full = bars, *q_empty = bars + 1, *k_full = bars + 2, *k_empty = bars + 3;
  uint64_t *v_full = bars + 4, *v_empty = bars + 5;

  int b = blockIdx.x;
  const int slice = b % slices;
  b /= slices;
  const int tile = b % tiles, nh = b / tiles;  // nh = n * heads + head
  const int n = nh / heads, head = nh - n * heads;
  const int q0 = tile * kWideTile, c0 = slice * width;
  const int cols = min(width, dv - c0);  // d_v columns of this block
  const int rows = min(kWideTile, Lq - q0);
  const int ldk = heads * dk, ldv = heads * dv;
  const int n_chunks = (dk + kWideDk - 1) / kWideDk;  // of d_k; 1: Q staged once
  const int n_blocks = (S + KB - 1) / KB;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bars + i, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, as the compiler can tell is the same for every thread of
  // a warp (so that it does not serialize the consumer's wgmma)
  if (__shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) == 1) {
    // ------------------------------------------------------------ producer
    const int t = threadIdx.x - 128;
    const float* qb = q + ((size_t)n * Lq + q0) * ldk + head * dk;
    const float* kb = k + (size_t)n * S * ldk + head * dk;
    const float* vb = v + (size_t)n * S * ldv + head * dv + c0;
    // item i of a tile of kWideDk columns: row 8(i / (8·kQRow)) + i % 8,
    // 4 columns at 4((i / 8) % kQRow), so 8 neighbouring threads write one
    // core matrix's 128 contiguous bytes
    auto item_row = [](int i) { return (i / (8 * kQRow)) * 8 + (i & 7); };
    auto item_col = [](int i) { return 4 * ((i >> 3) % kQRow); };
    auto stage_q = [&](int d0) {
#pragma unroll 1
      for (int j = 0; j < kQItems / 128; ++j) {
        const int i = j * 128 + t, r = item_row(i), c = item_col(i);
        copy4_f32<kNarrow>(q_lo + core_index(r, c, kWideDk), qb + (size_t)r * ldk + d0 + c,
                           r < rows ? dk - d0 - c : 0, q);
      }
      cp_async_commit();
      cp_async_wait<0>();
#pragma unroll 1
      for (int j = 0; j < kQItems / 128; ++j) {
        const int i = j * 128 + t, at = core_index(item_row(i), item_col(i), kWideDk);
        split4_in_place(q_lo + at, q_hi + at);
      }
    };
    // K item i (9 rounds of 128): as a Q item, of the key block's 16 rows;
    // V item i (3 rounds): keys 8g + p, + 2, + 4, + 6 (g = i % 2, p = (i /
    // 2) % 2) at the slice's columns 4(i / 4)..+3.  Both are loaded into
    // registers a stage ahead, so their loads are in flight while the
    // consumer multiplies, and split and stored once the stage is free.
    constexpr int kKRounds = (kKItems + 127) / 128, kVRounds = (kVItems + 127) / 128;
    float4 k_next[kKRounds], v_next[kVRounds][4];
    auto load_k = [&](int blk, int d0) {
#pragma unroll
      for (int j = 0; j < kKRounds; ++j) {
        const int i = j * 128 + t, r = item_row(i), c = item_col(i), key = blk * KB + r;
        k_next[j] = load4_f32<kNarrow>(kb + (size_t)key * ldk + d0 + c,
                                       (kKItems % 128 == 0 || i < kKItems) && key < S
                                           ? dk - d0 - c : 0);
      }
    };
    auto store_k = [&]() {
#pragma unroll
      for (int j = 0; j < kKRounds; ++j) {
        const int i = j * 128 + t;
        if (kKItems % 128 == 0 || i < kKItems) {
          const int at = core_index(item_row(i), item_col(i), kWideDk);
          split4_store(k_next[j], k_hi + at, k_lo + at);
        }
      }
    };
    auto load_v = [&](int blk) {
#pragma unroll
      for (int j = 0; j < kVRounds; ++j) {
        const int i = j * 128 + t, c = 4 * (i >> 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = blk * KB + 8 * (i & 1) + ((i >> 1) & 1) + 2 * e;
          v_next[j][e] = load4_f32<kNarrow>(
              vb + (size_t)key * ldv + c,
              (kVItems % 128 == 0 || i < kVItems) && key < S ? cols - c : 0);
        }
      }
    };
    // the V items split and transposed into Vᵀ: the four keys land at
    // positions 4p..4p + 3 of their 8-key group, one 16-byte word a column
    auto store_v = [&]() {
#pragma unroll
      for (int j = 0; j < kVRounds; ++j) {
        const int i = j * 128 + t;
        if (kVItems % 128 == 0 || i < kVItems) {
          const int c = 4 * (i >> 2), g = i & 1, p = (i >> 1) & 1;
          const float4* x = v_next[j];
          const float cols4[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x},
                                     {x[0].y, x[1].y, x[2].y, x[3].y},
                                     {x[0].z, x[1].z, x[2].z, x[3].z},
                                     {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int at = core_index(c + cc, 8 * g + 4 * p, KB);
            split4_store(make_float4(cols4[cc][0], cols4[cc][1], cols4[cc][2], cols4[cc][3]),
                         vt_hi + at, vt_lo + at);
          }
        }
      }
    };

    int k_uses = 0, q_uses = 0;
    load_k(0, 0);             // in flight while Q is staged
    if (!kNarrow) load_v(0);  // (kNarrow: loaded at its stage, which saves the registers)
    if (n_chunks == 1) {
      stage_q(0);
      fence_async_shared();
      mbar_arrive(q_full);
    }
    for (int blk = 0; blk < n_blocks; ++blk) {
      for (int ch = 0; ch < n_chunks; ++ch) {
        if (n_chunks > 1) {
          if (q_uses) mbar_wait(q_empty, (q_uses - 1) & 1);
          ++q_uses;
          stage_q(ch * kWideDk);
          fence_async_shared();
          mbar_arrive(q_full);
        }
        if (k_uses) mbar_wait(k_empty, (k_uses - 1) & 1);
        ++k_uses;
        store_k();
        fence_async_shared();
        mbar_arrive(k_full);
        if (ch + 1 < n_chunks)
          load_k(blk, (ch + 1) * kWideDk);
        else if (blk + 1 < n_blocks)
          load_k(blk + 1, 0);
      }
      if (kNarrow) load_v(blk);
      if (blk) mbar_wait(v_empty, (blk - 1) & 1);
      store_v();
      fence_async_shared();
      mbar_arrive(v_full);
      if (!kNarrow && blk + 1 < n_blocks) load_v(blk + 1);
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const float scale2 = scale * 1.4426950408889634f;
  const uint64_t d_qh = wgmma_desc(smem_u32(q_hi), kSboQK);
  const uint64_t d_ql = wgmma_desc(smem_u32(q_lo), kSboQK);
  const uint64_t d_kh = wgmma_desc(smem_u32(k_hi), kSboQK);
  const uint64_t d_kl = wgmma_desc(smem_u32(k_lo), kSboQK);
  const uint32_t vh = smem_u32(vt_hi), vl = smem_u32(vt_lo);
  float o[2][68];  // o[h][4i + e]: columns 136h + 8i + 2tq + e % 2, rows g + 8(e / 2)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 68; ++i) o[h][i] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY};  // running row max (scaled, base 2)
  float sum[2] = {0.0f, 0.0f};           // the lane's share of the row sum
  int q_uses = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    float s[8];  // s[4i + e]: keys 8i + 2tq + e % 2, rows g + 8(e / 2)
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (n_chunks > 1 || blk == 0) mbar_wait(q_full, q_uses++ & 1);
      mbar_wait(k_full, (blk * n_chunks + ch) & 1);
      const int steps = (min(kWideDk, dk - ch * kWideDk) + 7) / 8;  // k-steps of 8 columns
      wgmma_fence();
      // one k-step a turn (unrolled, the 4·34 descriptors would be hoisted
      // out of the key-block loop into registers); each step moves every
      // descriptor's start address by 256 bytes, 16 in its field
#pragma unroll 1
      for (int ks = 0; ks < steps; ++ks) {
        wgmma_n16_ss(s, d_ql + 16 * ks, d_kh + 16 * ks);
        wgmma_n16_ss(s, d_qh + 16 * ks, d_kl + 16 * ks);
        wgmma_n16_ss(s, d_qh + 16 * ks, d_kh + 16 * ks);
      }
      wgmma_commit_and_wait();
      fence_registers(s);
      mbar_arrive(k_empty);
      if (n_chunks > 1) mbar_arrive(q_empty);
    }

    // online softmax in base 2; a row lives in the 4 lanes of a quad
    const int valid = S - blk * KB;  // keys of this block below S
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i] = 8 * (i >> 2) + 2 * tq + (i & 1) < valid ? s[i] * scale2 : -INFINITY;
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) bm[(i >> 1) & 1] = fmaxf(bm[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
      bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
      const float m = fmaxf(mx[h], bm[h]);  // finite: every key block holds a key below S
      const float alpha = exp2f(mx[h] - m);  // 0 at the first key block
      sum[h] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 17; ++i) {
          o[j][4 * i + 2 * h] *= alpha;
          o[j][4 * i + 2 * h + 1] *= alpha;
        }
      mx[h] = m;
    }
    // p, split into tf32 hi and lo as p's A fragments: keys 8kk + 2tq and
    // + 1 sit at positions tq and tq + 4 of Vᵀ's 8-key group kk
    uint32_t p_hi[2][4], p_lo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int from[4] = {0, 2, 1, 3};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * kk + from[e];
        const float p = exp2f(s[i] - mx[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += p;
        split_tf32(p, p_hi[kk][e], p_lo[kk][e]);
      }
    }
    mbar_wait(v_full, blk & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t at = 256 * kk + h * (kWideHalf / 8) * kSboV;
        wgmma_n136_rs(o[h], p_lo[kk], wgmma_desc(vh + at, kSboV));
        wgmma_n136_rs(o[h], p_hi[kk], wgmma_desc(vl + at, kSboV));
        wgmma_n136_rs(o[h], p_hi[kk], wgmma_desc(vh + at, kSboV));
      }
    wgmma_commit_and_wait();
    fence_registers(o[0]);
    fence_registers(o[1]);
    mbar_arrive(v_empty);
  }

  // rows g and g + 8 of the warp, the block's columns: a pair of floats a
  // store where d_v is even (the row's pairs then 8-byte aligned), else one
  float* ob = out + ((size_t)n * Lq + q0 + 16 * warp) * ldv + head * dv + c0;
  const bool pairs = (dv & 1) == 0 && ((uintptr_t)out & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const float inv = 1.0f / sum[h];
    const int r = g + 8 * h;
    if (16 * warp + r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 17; ++i) {
        const int c = kWideHalf * j + 8 * i + 2 * tq;
        const float x = o[j][4 * i + 2 * h] * inv, y = o[j][4 * i + 2 * h + 1] * inv;
        if (pairs && c + 1 < cols) {
          *reinterpret_cast<float2*>(ob + (size_t)r * ldv + c) = make_float2(x, y);
        } else {
          if (c < cols) ob[(size_t)r * ldv + c] = x;
          if (c + 1 < cols) ob[(size_t)r * ldv + c + 1] = y;
        }
      }
  }
}

template <bool kNarrow>
int launch_wide_f32_as(const void* q, const void* k, const void* v, void* out, int N, int Lq,
                       int S, int heads, int dk, int dv, cudaStream_t stream) {
  static SmemOptIn opt_in;
  constexpr size_t smem = wide_f32_smem_bytes();
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  const cudaError_t err =
      opt_in.ensure((const void*)cross_modal_attn_wide_f32_kernel<kNarrow>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kWideTile - 1) / kWideTile, slices = wide_slices(dv);
  const long long blocks = (long long)N * heads * tiles * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cross_modal_attn_wide_f32_kernel<kNarrow><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Lq, S, heads, dk, dv, tiles, slices, wide_width(dv),
      1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

int launch_wide(const void* q, const void* k, const void* v, void* out, int N, int Lq, int S,
                int heads, int dk, int dv, bool bf16, bool narrow, bool round_p,
                cudaStream_t s) {
  if (!bf16 && narrow)
    return launch_wide_f32_as<true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (!bf16) return launch_wide_f32_as<false>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (round_p && narrow)
    return launch_wide_bf16_as<true, true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (round_p)
    return launch_wide_bf16_as<true, false>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  if (narrow)
    return launch_wide_bf16_as<false, true>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
  return launch_wide_bf16_as<false, false>(q, k, v, out, N, Lq, S, heads, dk, dv, s);
}

// ------------------------------------------ float32 key blocks on wgmma

constexpr int kF32WgTile = 128;     // query rows of a block: two consumer warpgroups of 64
constexpr int kF32WgThreads = 384;  // the two consumer warpgroups and a producer warpgroup
// registers a thread: 168 at launch (65,536 over 384 threads), then the
// producer gives some up to the consumers' accumulators
constexpr int kF32WgProducerRegs = 136, kF32WgConsumerRegs = 184;
// named barriers: 1 + w, consumer warpgroup w's Q; kF32WgTurn + w, its turn
// on the tensor cores
constexpr int kF32WgTurn = 3;
static_assert(kF32WgProducerRegs + 2 * kF32WgConsumerRegs <= 3 * 168, "one register file");

constexpr int kF32WgCols = 128;  // columns of d_k and d_v a block holds
constexpr int kF32WgKeys = 32;   // keys of a key block: q·kᵀ's N

// Blocks of a cluster at instance D (128 or 256), each holding 128 columns
// of d_k and of d_v: at D = 256 one block cannot hold the split 128-row Q
// tile (262,144 bytes)
__host__ __device__ constexpr int f32_wg_cluster(int D) { return D / kF32WgCols; }

// Shared memory of one block of cross_modal_attn_f32wg_blocks_kernel<D>:
// Q's hi and lo parts (128 rows of 128 columns), K's (a key block's rows of
// as many) and Vᵀ's (as many rows of a key block's keys), in floats, the
// peer's partial logits of two key blocks where the cluster has two
// blocks, and eight mbarriers
__host__ __device__ constexpr size_t f32_wg_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)kF32WgTile * kF32WgCols +
                          4 * (size_t)kF32WgKeys * kF32WgCols +
                          2 * (size_t)(f32_wg_cluster(D) - 1) * kF32WgTile * kF32WgKeys) +
         8 * sizeof(uint64_t);
}

// Component i of v (i from 0 to 3, a thread's own), by selects
__device__ __forceinline__ float pick4(float4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Named barrier `id` of `count` threads: wait for it, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster's blocks
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of p (in this block's shared memory) in block `rank`'s
__device__ __forceinline__ uint32_t peer_address(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// 16 bytes into the peer's shared memory at addr, asynchronously: their
// arrival counts 16 bytes of the transactions the peer's mbarrier at bar
// expects
__device__ __forceinline__ void store_peer4(uint32_t addr, float a, float b, float c, float d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// One arrival on this block's mbarrier, announcing `bytes` of transactions
// (the peer's asynchronous stores) that complete its phase with it
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// mbar_wait at cluster scope: the peer's writes before its arrivals are seen
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// D = 128 past S = 128, and D = 256 at any S: the keys streamed in key
// blocks, any d_k and d_v up to D (the tiles zero-filled past them), any S
// and any float32 pointer (kNarrow: Q, K and V one float a load).
// Replaces the mma.sync key-block kernel at these D (3xTF32 on mma.sync, 8
// warps of 16 query rows over 128-row tiles, 32-key blocks at D = 128 and
// 8-key blocks at D = 256, each warp splitting its Q fragments anew every
// key block: 0.6072-0.6080 ms at N = 200, Lq = 200, S = 200, h = 2, d = 256,
// 1.1× SDPA's time, and 0.4574-0.4583 at h = 4, d = 128).  What bounds it:
// operations, three tf32 products (0.0993 ms at both shapes at 495
// TFLOP/s), which mma.sync does not pass 81 TFLOP/s of; wgmma does, at a
// wide enough N: on the H100 (scripts/wgmma_rate_probe.py) m64n16k8 from
// shared memory reaches 30% of the tf32 peak with one warpgroup an SM,
// m64n32k8 52% (65% with two), m64n64k8 82% (97%), and with A from
// registers m64n128k8 91%.  The design: blocks of 128 query rows, two
// consumer warpgroups of 64 and a producer warpgroup, persistent (as many
// blocks, or clusters, as the card holds, each walking over (example,
// head, 128-row tile), a head's tiles side by side); every block holds 128
// columns of d_k and d_v, so at D = 256 a cluster of two blocks splits D.
// Each consumer warpgroup copies its 64 rows of Q by cp.async and splits
// them in place into tf32 hi and lo (the next tile's as soon as its last
// q·kᵀ of this one is done); the producer stages each 32-key block's K
// (split) and V (transposed, split), K-major in 8-row by 16-byte core
// matrices, from values loaded into its registers a key block ahead (16
// bytes a load, 4 with kNarrow; V's 4 columns of 4 keys written in a
// rotated order, so no two of 8 neighbouring threads hit one bank), each
// handed over by a full and an empty mbarrier, K a key block ahead of V.
// A consumer warpgroup takes the online softmax of a key block in base 2
// in its accumulators, then, on its turn on the tensor cores (two named
// barriers hand the turn back and forth, so one warpgroup's softmax runs
// under the other's products), issues q·kᵀ of the next key block, wgmma
// m64n32k8 from shared memory in 3xTF32 (q_lo·k_hi, q_hi·k_lo, then
// q_hi·k_hi each k-step), and p·v of this one, wgmma m64n128k8 with p's hi
// and lo parts as A from registers (the logits' accumulator layout is p's
// A layout once each 8 keys of Vᵀ are in the order 0, 2, 4, 6, 1, 3, 5, 7)
// and Vᵀ from shared memory.  At D = 256 each block's logits cover its
// half of d_k; it sends them to the other block's shared memory by
// st.async, whose bytes complete that block's mbarrier (no release fence:
// an arrival at cluster scope after remote stores cost about 1,500 clocks
// a key block), and both add the two halves in the same order, so their
// softmax is the same.  The split 128-row Q tile of 128 columns takes
// 131,072 bytes, a key block of K and one of Vᵀ 32,768 each: one block an
// SM, one stage each (a second Vᵀ stage at D = 128 bought nothing), 32-key
// blocks (64-key blocks do not fit beside both warpgroups' Q).  Each step
// of the two warpgroups ran at about 60% of the tf32 peak while they issue
// q·kᵀ's 48 small wgmma, whose issue stalls as they execute, so the
// products of one warpgroup do not overlap its own softmax
// (scripts/f32_key_block_probe.py times the rows of PERF.md).
template <int D, bool kNarrow>
__global__ void __launch_bounds__(kF32WgThreads, 1)
cross_modal_attn_f32wg_blocks_kernel(const float* __restrict__ q,  // (N, Lq, h*dk)
                                     const float* __restrict__ k,  // (N, S, h*dk)
                                     const float* __restrict__ v,  // (N, S, h*dv)
                                     float* __restrict__ out,      // (N, Lq, h*dv)
                                     int Lq, int S, int heads, int dk, int dv, int tiles,
                                     int work, float scale) {
  constexpr int C = f32_wg_cluster(D), DH = kF32WgCols, KB = kF32WgKeys;
  static_assert(D == 128 || D == 256, "one block, or a cluster of two, of 128 columns");
  constexpr int kRow = DH / 4;  // 16-byte items of a Q or K row
  constexpr int kKRounds = KB * kRow / 128;
  constexpr int kVRounds = kRow * (KB / 4) / 128;  // V items: 4 columns of 4 keys
  static_assert(64 * kRow % 128 == 0 && KB * kRow % 128 == 0 && kRow * (KB / 4) % 128 == 0 &&
                    kRow % 8 == 0,
                "whole rounds of 128 threads");
  constexpr uint32_t kSboQK = 32 * DH, kSboV = 32 * KB;  // bytes from 8 rows to the next
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_hi = reinterpret_cast<float*>(smem_raw);  // (128, DH), core order
  float* q_lo = q_hi + kF32WgTile * DH;
  float* k_hi = q_lo + kF32WgTile * DH;  // (KB, DH), core order
  float* k_lo = k_hi + KB * DH;
  float* vt_hi = k_lo + KB * DH;  // (DH, KB), core order
  float* vt_lo = vt_hi + DH * KB;
  // the peer's partial logits: (buffer, warpgroup, KB / 8, 128 threads, 4)
  float* xs = vt_lo + DH * KB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + 2 * (C - 1) * kF32WgTile * KB);
  uint64_t *k_full = bars, *k_empty = bars + 1, *v_full = bars + 2, *v_empty = bars + 3;
  uint64_t* x_full = bars + 4;  // x_full[2 · buffer + warpgroup]

  uint32_t rank = 0;  // the block's place in its cluster: which half of D it holds
  if constexpr (C > 1) rank = cluster_rank();
  const int c0 = rank * DH;  // the block's first column of d_k and d_v
  const int ldk = heads * dk, ldv = heads * dv;
  const int dk_left = dk - c0, dv_left = dv - c0;  // the block's columns below d_k, d_v
  const int n_blocks = (S + KB - 1) / KB;
  // the cluster's query tiles: (example, head, 128-row tile) number
  // blockIdx.x / C, then every gridDim.x / C on, below `work`; their key
  // blocks one sequence, key block g of the cluster's tile g / n_blocks
  const int first = blockIdx.x / C, stride = gridDim.x / C;
  const int n_tiles = first < work ? (work - first + stride - 1) / stride : 0;
  const int n_steps = n_tiles * n_blocks;
  struct Tile {
    int n, head, q0, rows;
  };
  auto tile_of = [&](int i) {  // the cluster's i-th tile
    const int w = first + i * stride, nh = w / tiles;
    const int q0 = (w - nh * tiles) * kF32WgTile;
    return Tile{nh / heads, nh % heads, q0, min(kF32WgTile, Lq - q0)};
  };

  if (threadIdx.x == 0) {
    mbar_init(k_full, 128);
    mbar_init(v_full, 128);
    mbar_init(k_empty, 256);  // both consumer warpgroups
    mbar_init(v_empty, 256);
    if (C > 1)  // one arrival (the receiver's) and the peer's bytes a phase
      for (int i = 0; i < 4; ++i) mbar_init(x_full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C > 1)
    cluster_sync();  // the peer's barriers are initialised before any arrival
  else
    __syncthreads();

  // item i of a Q or K tile: row 8(i / (8·kRow)) + i % 8, columns
  // 4((i / 8) % kRow)..+3, so 8 neighbouring threads write one core
  // matrix's 128 contiguous bytes and a warp reads 8 rows' 64 bytes
  auto item_row = [](int i) { return (i / (8 * kRow)) * 8 + (i & 7); };
  auto item_col = [](int i) { return 4 * ((i >> 3) % kRow); };
  // the warpgroup, as the compiler can tell is the same for every thread of
  // a warp (so that it does not serialize the consumers' wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32WgProducerRegs));
    const int t = threadIdx.x - 256;
    // item i of V: 4 columns 4cq..+3 of the block's slice, cq = 8(i / (8·KB
    // / 4)) + i % 8, of the 4 keys of Vᵀ's 16-byte chunk kc = (i / 8) % (KB
    // / 4): keys 8(kc / 2) + kc % 2 + 2e, at positions 4(kc % 2) + e of
    // their 8-key group.  A warp reads 128 bytes of each of 4 keys' rows;
    // each thread writes its 4 columns in an order rotated by cq / 2 % 4, so
    // the 8 threads of one chunk write 8 different rows modulo 8 at once
    auto v_quad = [](int i) { return (i / (2 * KB)) * 8 + (i & 7); };
    auto v_chunk = [](int i) { return (i >> 3) % (KB / 4); };
    float4 k_next[kKRounds], v_next[kVRounds][4];
    // the first key of step g, and its head's rows of K and V
    auto keys_of = [&](int g, const float*& kb, const float*& vb) {
      const Tile w = tile_of(g / n_blocks);
      kb = k + (size_t)w.n * S * ldk + w.head * dk + c0;
      vb = v + (size_t)w.n * S * ldv + w.head * dv + c0;
      return (g % n_blocks) * KB;
    };
    auto load_k = [&](int g) {
      const float* kb;
      const float* vb;
      const int s0 = keys_of(g, kb, vb);
#pragma unroll
      for (int j = 0; j < kKRounds; ++j) {
        const int i = j * 128 + t, c = item_col(i), key = s0 + item_row(i);
        k_next[j] = load4_f32<kNarrow>(kb + (size_t)key * ldk + c, key < S ? dk_left - c : 0);
      }
    };
    auto store_k = [&]() {
#pragma unroll
      for (int j = 0; j < kKRounds; ++j) {
        const int i = j * 128 + t, at = core_index(item_row(i), item_col(i), DH);
        split4_store(k_next[j], k_hi + at, k_lo + at);
      }
    };
    auto load_v = [&](int g) {
      const float* kb;
      const float* vb;
      const int s0 = keys_of(g, kb, vb);
#pragma unroll
      for (int j = 0; j < kVRounds; ++j) {
        const int i = j * 128 + t, c = 4 * v_quad(i), kc = v_chunk(i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + 8 * (kc >> 1) + (kc & 1) + 2 * e;
          v_next[j][e] = load4_f32<kNarrow>(vb + (size_t)key * ldv + c,
                                            key < S ? dv_left - c : 0);
        }
      }
    };
    auto store_v = [&]() {
#pragma unroll
      for (int j = 0; j < kVRounds; ++j) {
        const int i = j * 128 + t, cq = v_quad(i), kc = v_chunk(i);
        const float4* x = v_next[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int rr = (r + ((i & 7) >> 1)) & 3, at = core_index(4 * cq + rr, 4 * kc, KB);
          split4_store(make_float4(pick4(x[0], rr), pick4(x[1], rr), pick4(x[2], rr),
                                   pick4(x[3], rr)),
                       vt_hi + at, vt_lo + at);
        }
      }
    };

    // K a step ahead of V: the consumers multiply q·kᵀ of the next key
    // block with p·v of this one
    if (n_steps) {
      load_k(0);
      load_v(0);
      store_k();
      fence_async_shared();
      mbar_arrive(k_full);
      if (n_steps > 1) load_k(1);
    }
    for (int g = 0; g < n_steps; ++g) {
      if (g + 1 < n_steps) {
        mbar_wait(k_empty, g & 1);
        store_k();
        fence_async_shared();
        mbar_arrive(k_full);
        if (g + 2 < n_steps) load_k(g + 2);
      }
      if (g) mbar_wait(v_empty, (g - 1) & 1);
      store_v();
      fence_async_shared();
      mbar_arrive(v_full);
      if (g + 1 < n_steps) load_v(g + 1);
    }
  } else {
    // ---------------------------------------------- consumer warpgroup `role`
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32WgConsumerRegs));
    const int ct = threadIdx.x & 127, warp = ct >> 5, lane = threadIdx.x & 31;
    const int g4 = lane >> 2, tq = lane & 3;
    const float scale2 = scale * 1.4426950408889634f;
    // the warpgroup's 64 rows of Q (8 groups of 8 rows, 32·DH bytes each,
    // on), copied by its threads into the lo part by cp.async and split
    // there in place: the next tile's as soon as the last q·kᵀ of this one
    // is done, while the warpgroup finishes it
    float* wq_hi = q_hi + 64 * DH * role;
    float* wq_lo = q_lo + 64 * DH * role;
    auto copy_q = [&](const Tile& w) {
      const float* qb = q + ((size_t)w.n * Lq + w.q0 + 64 * role) * ldk + w.head * dk + c0;
      const int wrows = w.rows - 64 * role;  // the warpgroup's rows below Lq
#pragma unroll 4
      for (int j = 0; j < kRow / 2; ++j) {
        const int i = j * 128 + ct, r = item_row(i), c = item_col(i);
        copy4_f32<kNarrow>(wq_lo + core_index(r, c, DH), qb + (size_t)r * ldk + c,
                           r < wrows ? dk_left - c : 0, q);
      }
      cp_async_commit();
    };
    auto split_q = [&]() {
      cp_async_wait<0>();
#pragma unroll 4
      for (int j = 0; j < kRow / 2; ++j) {
        const int i = j * 128 + ct, at = core_index(item_row(i), item_col(i), DH);
        split4_in_place(wq_lo + at, wq_hi + at);
      }
      fence_async_shared();
      named_sync(1 + role, 128);  // the warpgroup's Q
    };
    const uint64_t d_qh = wgmma_desc(smem_u32(wq_hi), kSboQK);
    const uint64_t d_ql = wgmma_desc(smem_u32(wq_lo), kSboQK);
    const uint64_t d_kh = wgmma_desc(smem_u32(k_hi), kSboQK);
    const uint64_t d_kl = wgmma_desc(smem_u32(k_lo), kSboQK);
    const uint32_t vh = smem_u32(vt_hi), vl = smem_u32(vt_lo);
    uint32_t xs_peer = 0, x_full_peer = 0;  // the peer's partial logits and their barriers
    if constexpr (C > 1) {
      xs_peer = peer_address(xs, rank ^ 1);
      x_full_peer = peer_address(x_full, rank ^ 1);
    }
    // q·kᵀ of step g into s, issued (not waited for)
    auto issue_qk = [&](float (&s)[KB / 2], int g) {
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) s[i] = 0.0f;
      mbar_wait(k_full, g & 1);
      wgmma_fence();
      // one k-step a turn; each moves every descriptor's start by 256 bytes
#pragma unroll 1
      for (int ks = 0; ks < DH / 8; ++ks) {
        wgmma_n32_ss(s, d_ql + 16 * ks, d_kh + 16 * ks);
        wgmma_n32_ss(s, d_qh + 16 * ks, d_kl + 16 * ks);
        wgmma_n32_ss(s, d_qh + 16 * ks, d_kh + 16 * ks);
      }
    };
    // the partial logits over this block's half of d_k to the peer's
    // warpgroup of the same rows, in 16-byte words a thread (buffer g % 2),
    // by asynchronous stores that count down the peer's barrier of the slot
    auto send = [&](const float (&s)[KB / 2], int g) {
      if constexpr (C > 1) {
        const int slot = 2 * (g & 1) + role;
        const uint32_t to = xs_peer + 16u * (uint32_t)(slot * (KB / 8) * 128 + ct);
#pragma unroll
        for (int j = 0; j < KB / 8; ++j)
          store_peer4(to + 16u * 128u * j, s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3],
                      x_full_peer + 8u * slot);
      }
    };
    float o[DH / 2];  // o[4i + e]: the slice's column 8i + 2tq + e % 2, row g4 + 8(e / 2)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float mx[2] = {-INFINITY, -INFINITY};  // running row max (scaled, base 2)
    float sum[2] = {0.0f, 0.0f};           // the lane's share of the row sum
    float s[KB / 2];  // s[4i + e]: key 8i + 2tq + e % 2 of step g, row g4 + 8(e / 2)
    Tile w = tile_of(0);
    if (n_steps) {
      copy_q(w);
      split_q();
      issue_qk(s, 0);
      wgmma_commit_and_wait();
      fence_registers(s);
      mbar_arrive(k_empty);
      if (n_blocks == 1 && n_tiles > 1) copy_q(tile_of(1));  // this tile's Q is done with
      send(s, 0);
      if (role == 1) named_arrive(kF32WgTurn, 256);  // the first turn is warpgroup 0's
    }
    for (int g = 0; g < n_steps; ++g) {
      const int blk = g % n_blocks;
      const bool more = g + 1 < n_steps, last = blk + 1 == n_blocks;
      if constexpr (C > 1) {
        // the peer's partial logits added: a + b in one block, b + a in the
        // other, the same float
        const int slot = 2 * (g & 1) + role;
        if (ct == 0) mbar_arrive_expect_tx(x_full + slot, 128 * (KB / 2) * sizeof(float));
        mbar_wait_cluster(x_full + slot, (g >> 1) & 1);
        const float4* from = reinterpret_cast<const float4*>(xs) + slot * (KB / 8) * 128 + ct;
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
          const float4 y = from[128 * j];
          s[4 * j] += y.x;
          s[4 * j + 1] += y.y;
          s[4 * j + 2] += y.z;
          s[4 * j + 3] += y.w;
        }
      }

      // online softmax in base 2; a row lives in the 4 lanes of a quad
      const int valid = S - blk * KB;  // keys of this block below S
#pragma unroll
      for (int i = 0; i < KB / 2; ++i)
        s[i] = 8 * (i >> 2) + 2 * tq + (i & 1) < valid ? s[i] * scale2 : -INFINITY;
      float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) bm[(i >> 1) & 1] = fmaxf(bm[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
        bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
        const float m = fmaxf(mx[h], bm[h]);  // finite: every key block holds a key below S
        const float alpha = exp2f(mx[h] - m);  // 0 at a tile's first key block
        sum[h] *= alpha;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          o[4 * i + 2 * h] *= alpha;
          o[4 * i + 2 * h + 1] *= alpha;
        }
        mx[h] = m;
      }
      // p, split into tf32 hi and lo as p's A fragments: keys 8kk + 2tq and
      // + 1 sit at positions tq and tq + 4 of Vᵀ's 8-key group kk
      uint32_t p_hi[KB / 8][4], p_lo[KB / 8][4];
#pragma unroll
      for (int kk = 0; kk < KB / 8; ++kk) {
        const int from[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * kk + from[e];
          const float p = exp2f(s[i] - mx[(i >> 1) & 1]);
          sum[(i >> 1) & 1] += p;
          split_tf32(p, p_hi[kk][e], p_lo[kk][e]);
        }
      }
      if (more && last) split_q();  // the next tile's Q, copied since its last q·kᵀ

      // this warpgroup's turn on the tensor cores: q·kᵀ of the next step
      // and p·v of this one, then the other warpgroup's turn while this one
      // waits for them and takes the next softmax
      named_sync(kF32WgTurn + role, 256);
      if (more) issue_qk(s, g + 1);
      mbar_wait(v_full, g & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 8; ++kk) {
        wgmma_n128_rs(o, p_lo[kk], wgmma_desc(vh + 256 * kk, kSboV));
        wgmma_n128_rs(o, p_hi[kk], wgmma_desc(vl + 256 * kk, kSboV));
        wgmma_n128_rs(o, p_hi[kk], wgmma_desc(vh + 256 * kk, kSboV));
      }
      if (role == 0 || more) named_arrive(kF32WgTurn + (role ^ 1), 256);
      wgmma_commit_and_wait();
      fence_registers(o);
      mbar_arrive(v_empty);
      if (more) {
        fence_registers(s);
        mbar_arrive(k_empty);
        // the next step is its tile's last: this tile's Q is done with
        const int tile_next = (g + 1) / n_blocks;
        if ((g + 2) % n_blocks == 0 && tile_next + 1 < n_tiles) copy_q(tile_of(tile_next + 1));
        send(s, g + 1);
      }
      if (last) {
        // the tile's rows g4 and g4 + 8 of the warp, the block's columns
        // below d_v: a pair of floats a store where d_v is even (the row's
        // pairs then 8-byte aligned), else one
        const int row0 = 64 * role + 16 * warp;
        float* ob = out + ((size_t)w.n * Lq + w.q0 + row0) * ldv + w.head * dv + c0;
        const bool pairs = (dv & 1) == 0 && ((uintptr_t)out & 7) == 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          const float inv = 1.0f / sum[h];
          const int r = g4 + 8 * h;
          if (row0 + r < w.rows) {
#pragma unroll
            for (int i = 0; i < DH / 8; ++i) {
              const int c = 8 * i + 2 * tq;
              const float x = o[4 * i + 2 * h] * inv, y = o[4 * i + 2 * h + 1] * inv;
              if (pairs && c + 1 < dv_left) {
                *reinterpret_cast<float2*>(ob + (size_t)r * ldv + c) = make_float2(x, y);
              } else {
                if (c < dv_left) ob[(size_t)r * ldv + c] = x;
                if (c + 1 < dv_left) ob[(size_t)r * ldv + c + 1] = y;
              }
            }
          }
          mx[h] = -INFINITY;
          sum[h] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
        if (more) w = tile_of((g + 1) / n_blocks);
      }
    }
  }
  // neither block of a cluster leaves while the other may still write to it
  if constexpr (C > 1) cluster_sync();
}

template <int D, bool kNarrow>
int launch_f32wg_blocks(const void* q, const void* k, const void* v, void* out, int N,
                        int Lq, int S, int heads, int dk, int dv, cudaStream_t stream) {
  constexpr int C = f32_wg_cluster(D);
  static SmemOptIn opt_in;
  constexpr size_t smem = f32_wg_smem_bytes(D);
  static_assert(smem <= (size_t)kMaxSmem, "tiles fit in one block's shared memory");
  void (*kernel)(const float*, const float*, const float*, float*, int, int, int, int, int, int,
                 int, float) = cross_modal_attn_f32wg_blocks_kernel<D, kNarrow>;
  cudaError_t err = opt_in.ensure((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + kF32WgTile - 1) / kF32WgTile;
  const long long work = (long long)N * heads * tiles;  // query tiles
  if (work * C > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kF32WgThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = C > 1 ? 1 : 0;
  // persistent: as many blocks (clusters) as the card holds at once, each
  // walking over query tiles
  static int resident_on[kMaxDevices] = {};  // clusters the device holds at once, once known
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int resident = resident_on[dev];
  if (resident < 1) {
    config.gridDim = dim3(C);
    if (C > 1)
      err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
    else
      err = cudaDeviceGetAttribute(&resident, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    resident_on[dev] = resident;
  }
  config.gridDim = dim3((unsigned)(C * (work < resident ? work : resident)));
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Lq, S, heads, dk, dv, tiles,
      (int)work, 1.0f / sqrtf((float)dk));
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
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
// pointer (the kFill instance).  The
// tensor-core float32 routes take any dk and dv from 1, route 2 up to 128
// and S <= 128, route 3 up to 256 and any S >= 1 (the wrapper sends S >
// 128 and d above 128 to route 3, and S > 128 to route 4; a smaller S only
// to time them against routes 1 and 2); routes 5 and 6 take any dk, dv
// and S from 1 (the wrapper sends float32 d above 256 and bfloat16 d above
// 128 there).  narrow (routes 2-6) is required for pointers off 16 bytes
// or d off a multiple of 4 (float32) or of 8 (bfloat16), and takes any:
// in float32 it copies one float at a time (4-byte cp.async); in bfloat16
// (route 4, then the zero-filled instance for every bf16 call but the
// aligned dk = dv, a multiple of 16; and route 6) each of q, k and v is
// copied by the widest cp.async its pointer and d allow, 16, 8 or 4 bytes,
// or by shifted 16-byte loads (bf16_copy_width), and the output rows leave
// in 16-byte stores where whole words of them lie (store_rows_any_bf16).
// The CUDA-core
// float32 route takes any sizes whose q rows and probabilities fit in
// shared memory.  round_p (for the bfloat16 routes only): p rounded to bf16
// once before p·v, as XLA's attention in the JAX package rounds it
// (TPU.PALLAS_ATTENTION off, the default); without it p keeps about 16
// bits (p_hi + p_lo), as the Pallas kernel's float32 p.
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
