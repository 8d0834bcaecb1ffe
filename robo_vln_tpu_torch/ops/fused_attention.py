"""Fused cross-modal attention: the CUDA kernel ``csrc/cross_modal_attn.cu``,
its wrapper, its plain version and its launch counter.

Counterpart of robo_vln_tpu/ops/pallas_attention.py: per (example, head),
``softmax(q·kᵀ/√d_k)·v`` with no mask, the output in q's dtype.  q (N, Lq,
h·d_k), k (N, S, h·d_k), v (N, S, h·d_v) -> (N, Lq, h·d_v); the kernel
addresses the heads by stride, so there are no transposes around the call.
Four routes, picked before the launch by :func:`pick_route` from the dtype
and the sizes; every float32 and bfloat16 call with d_k, d_v, S >= 1 has
one (only a wrong dtype or layout, pointers off their element size or heads
that do not divide the width raise, in the wrapper, before any launch):

* ``f32_tensor_core``: float32, both products on the tensor cores in 3xTF32
  (each operand split into two tf32 parts, three products), so the result
  is float32-accurate.  It takes any d_k and d_v from 1 to
  :data:`F32_MAX_D` and any S >= 1, from any float32 pointer: every float32
  call of the HCM agent, longer S such as self-attention's, and head sizes
  off a multiple of 8, which the kernels zero-fill in shared memory to the
  instance's D (32, 64, 128 or 256).  Up to S = 128 and d = 128 one kernel
  holds a head's keys whole; past either another streams them in key
  blocks of 8-key chunks (:func:`f32_key_chunks`) with an online softmax
  (the C entry's code :data:`F32_KEY_BLOCKS`, counted apart in
  :data:`f32_key_block_launches`).  Both copy 16 bytes at a time where q, k
  and v are aligned to 16 bytes and d_k and d_v are multiples of 4, else
  one float at a time (:func:`f32_narrow_copies`; those launches are also
  counted in :data:`f32_narrow_launches`).
* ``wide_f32`` and ``wide_bf16``: the wide-head kernel, for float32 with
  d_k or d_v above 256 and bfloat16 above 128, any S and alignment: on the
  tensor cores (3xTF32 in float32; one tf32 product of bf16 values, exact
  in float32, in bfloat16), keys in key blocks of :data:`WIDE_KEYS`, the
  logits over d_k in chunks of :data:`WIDE_CHUNK` columns, one block a
  slice of d_v (:func:`wide_slices`), one value a load where the pointers
  or d ask for it (:func:`wide_narrow_copies`; counted in
  :data:`wide_narrow_launches`).
* ``f32_cuda_core``: the first float32 kernel, on the CUDA cores.  No call is
  routed there since the wide kernel took its shapes; it launches only
  where :func:`pick_route` is replaced to force it (to time it beside its
  successor), and refuses d_k + S > 7264.
* ``bf16``: both products on the tensor cores, the softmax in float32, the
  probabilities p in one of two modes (:data:`BF16_P_MODES`, counted apart
  in :data:`bf16_mode_launches`), picked by
  ``cm_attention.float32_probabilities()``: ``round_p`` (the default, the
  JAX package's default XLA attention) rounds p to bf16 once before p·v;
  ``split_p`` (JAX's ``TPU.PALLAS_ATTENTION`` on, its Pallas kernel's
  float32 p) keeps p to about 16 bits (``p_hi + p_lo``), so the only
  rounding left against the float32 function is that of the bf16 output.
  It takes
  any d_k and d_v up to 128 and any S >= 1.  For d_k = d_v, a multiple of
  16, from pointers aligned to 16 bytes (every HCM call): up to S = 128 one
  kernel holds a head's keys whole; past it another
  streams them through a ring of
  :data:`BF16_STAGES` key blocks of :data:`BF16_KEY_CHUNKS` 16-key chunks
  with an online softmax against a lazy row max (the C entry's code
  :data:`BF16_KEY_BLOCKS`, counted apart in :data:`bf16_key_block_launches`).
  Every other call (:func:`bf16_fill`; counted in :data:`bf16_fill_launches`)
  takes that key-block kernel's fill instance at any S: the tiles
  zero-filled past d_k and d_v to the instance's D (their larger rounded up
  to 16: :func:`bf16_instance_d`), every value copied one at a time.

On a CPU tensor the plain version (:func:`attention_plain`, in the mode
set) runs; on a CUDA tensor the kernel launches, or the wrapper raises.  The
backward pass replays the plain version in the ``round_p`` mode, which is
``cm_attention.mha_attention`` in the inputs' dtype: the XLA function that
the JAX package differentiates in either mode (its default's own, and the
one its custom VJP replays, pallas_attention.py:133-136), in the profiler
range ``cross_modal_attn.backward_replay``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from . import _build, cm_attention

# codes of the C entry (wide_bf16's is the wide kernel's bfloat16 instance)
ROUTES = {"f32_cuda_core": 0, "bf16": 1, "f32_tensor_core": 2, "wide_f32": 5, "wide_bf16": 6}
launches = 0  # kernel launches since the last reset
route_launches = dict.fromkeys(ROUTES, 0)  # the same, by route
f32_key_block_launches = 0  # of f32_tensor_core's, those in key blocks (f32_key_blocks)
f32_narrow_launches = 0  # of f32_tensor_core's, those copying one float at a time
F32_KEY_BLOCKS = 3  # code of the C entry for f32_tensor_core's key blocks
bf16_key_block_launches = 0  # of bf16's, those in key blocks (bf16_key_blocks)
bf16_fill_launches = 0  # of bf16's, those of the fill instance (bf16_fill)
wide_narrow_launches = 0  # of the wide kernel's, those loading one value at a time
BF16_KEY_BLOCKS = 4  # code of the C entry for bf16's key blocks
BF16_P_MODES = ("round_p", "split_p")  # p rounded to bf16 once, or p_hi + p_lo
bf16_mode_launches = dict.fromkeys(BF16_P_MODES, 0)  # bf16's, by mode

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
WARPS = 8  # kWarps of csrc/cross_modal_attn.cu (f32_cuda_core route)
TILE_Q = 64  # kTileQ of csrc/cross_modal_attn.cu (bf16 route, keys whole)
BF16_WHOLE_S = 128  # the most keys bf16 holds whole; past it, key blocks
BF16_BLOCK_WARPS = 4  # kBf16BlockWarps: 16 query rows each
BF16_KEY_CHUNKS = 2  # kBf16KeyChunks: 16-key chunks a key block
BF16_STAGES = 3  # kBf16Stages: key blocks in the ring
F32_TILE_Q = 128  # kF32Tile of csrc/cross_modal_attn.cu (f32_tensor_core route)
F32_WHOLE_S = 128  # the most keys f32_tensor_core holds whole; past it, key blocks
F32_WHOLE_MAX_D = 128  # the largest D f32_tensor_core holds whole; past it, key blocks
F32_MAX_D = 256  # the largest d_k and d_v of f32_tensor_core
F32_KEY_CHUNKS = 4  # kF32KeyChunks: 8-key chunks a key block, D <= 128
F32_KEY_CHUNKS_D256 = 1  # kF32KeyChunksD256: the same at D = 256
MAX_D = 128  # the largest head size of the bf16 kernels; past it, the wide kernel
WIDE_WARPS = 4  # kWideWarps of csrc/cross_modal_attn.cu: 16 query rows each
WIDE_KEYS = 32  # kWideKeys: keys of a key block
WIDE_CHUNK = 32  # kWideChunk: d_k columns of a chunk of q·kᵀ
WIDE_SLICE = 128  # kWideSlice: the most d_v columns of a block
WIDE_STAGES = 3  # kWideStages: chunks of Q and K in the ring


def tensor_core_f32_takes(S: int, dk: int, dv: int) -> bool:
    """Whether the float32 tensor-core route takes these sizes: any d_k and
    d_v from 1 to 256 and any S >= 1 (from any float32 pointer)."""
    return S >= 1 and all(1 <= d <= F32_MAX_D for d in (dk, dv))


def f32_instance_d(dk: int, dv: int) -> int:
    """D of the float32 tensor-core instance: max(d_k, d_v) rounded up to
    32, 64, 128 or 256; the tiles are zero-filled past d_k and d_v."""
    return next(b for b in (32, 64, 128, 256) if max(dk, dv) <= b)


def f32_key_chunks(d: int) -> int:
    """8-key chunks of one float32 key block at instance D = d."""
    return F32_KEY_CHUNKS if d <= F32_WHOLE_MAX_D else F32_KEY_CHUNKS_D256


def f32_key_blocks(S: int, dk: int, dv: int) -> bool:
    """Whether a float32 tensor-core call streams its keys in key blocks:
    past S = 128, and at every S where D = 256."""
    return S > F32_WHOLE_S or f32_instance_d(dk, dv) > F32_WHOLE_MAX_D


def f32_narrow_copies(dk: int, dv: int, aligned: bool) -> bool:
    """Whether the float32 tensor-core kernels copy one float at a time:
    unless q, k and v are aligned to 16 bytes and d_k and d_v are multiples
    of 4, a 16-byte copy would start off a 16-byte boundary or take columns
    of the next head."""
    return not aligned or dk % 4 != 0 or dv % 4 != 0


def _f32_key_block_smem(d: int) -> int:
    """f32tc_blocks_smem_bytes: the Q tile, one key block split, the next
    one as it is."""
    kc = f32_key_chunks(d)
    return 4 * (F32_TILE_Q * (d + 8) + 8 * kc * (2 * d + 8) + 4 * kc * (4 * d + 8)
                + 16 * kc * d)


def bf16_instance_d(dk: int, dv: int) -> int:
    """D of the bf16 instance: max(d_k, d_v) rounded up to 16; the tiles are
    zero-filled past d_k and d_v."""
    return -(-max(dk, dv) // 16) * 16


def bf16_fill(dk: int, dv: int, aligned: bool) -> bool:
    """Whether a bf16 call takes the key-block kernel's fill instance (one
    value a copy, zero-filled past d_k and d_v): unless d_k = d_v, a
    multiple of 16, and q, k and v are aligned to 16 bytes, the instance's
    tiles would take values of the next head, or a 16-byte copy would start
    off a 16-byte boundary."""
    return not aligned or dk != dv or dk % 16 != 0


def bf16_key_blocks(S: int, dk: int, dv: int, aligned: bool = True) -> bool:
    """Whether a bf16 call streams its keys in key blocks: past S = 128, and
    at every S in the fill instance (only the key-block kernel has it)."""
    return S > BF16_WHOLE_S or bf16_fill(dk, dv, aligned)


def wide_slices(dv: int) -> int:
    """Slices of d_v of the wide kernel, one block each: ceil(d_v / 128)."""
    return -(-dv // WIDE_SLICE)


def wide_width(dv: int) -> int:
    """Columns of one slice: d_v over the slices, rounded up to 8."""
    per = -(-dv // wide_slices(dv))
    return -(-per // 8) * 8


def wide_narrow_copies(dtype, dk: int, dv: int, aligned: bool) -> bool:
    """Whether the wide kernel loads one value at a time: as the float32
    tensor-core kernels in float32 (d a multiple of 4), as the bf16 kernels
    in bfloat16 (d a multiple of 8)."""
    if dtype == torch.bfloat16:
        return not aligned or dk % 8 != 0 or dv % 8 != 0
    return f32_narrow_copies(dk, dv, aligned)


def _wide_smem(dtype) -> int:
    """wide_smem_bytes<T>: the ring's stages of a Q chunk (64 rows) and a K
    chunk (32 rows), in rows of 40 values, and a V slice (32 rows of 132
    floats or 136 bf16), in the inputs' dtype, whatever the sizes."""
    size, pad = (2, 8) if dtype == torch.bfloat16 else (4, 4)
    return size * (WIDE_STAGES * (16 * WIDE_WARPS + WIDE_KEYS) * (WIDE_CHUNK + 8)
                   + WIDE_KEYS * (WIDE_SLICE + pad))


def _bf16_key_block_smem(d: int) -> int:
    """bf16_blocks_smem_bytes: the Q tile and the ring's stages of K and V,
    in rows of d + 8 values."""
    return 2 * (d + 8) * (16 * BF16_BLOCK_WARPS + 2 * BF16_STAGES * 16 * BF16_KEY_CHUNKS)


def pick_route(dtype, S: int, dk: int, dv: int, aligned: bool = True) -> str:
    """The kernel a call launches, decided before the launch, never after a
    failure: for bfloat16 the bf16 kernels up to d = 128 and the wide
    kernel past it; in float32 the tensor-core kernels up to d = 256 (either
    alignment) and the wide kernel past it.  Raises only where no function
    exists: S, d_k or d_v below 1."""
    check_bf16_route(S, dk, dv, aligned)
    if dtype == torch.bfloat16:
        return "bf16" if max(dk, dv) <= MAX_D else "wide_bf16"
    return "f32_tensor_core" if tensor_core_f32_takes(S, dk, dv) else "wide_f32"


def smem_bytes(S: int, dk: int, dv: int, dtype=torch.float32, route=None) -> int:
    """Shared memory of one block of ``route`` (by default the route
    :func:`pick_route` picks).
    wide_f32, wide_bf16: whatever the sizes, the ring's stages of a Q and a
    K chunk and one V slice of a key block (wide_smem_bytes).
    f32_cuda_core: K (padded rows) and V where they fit (f32_smem_bytes in
    csrc/cross_modal_attn.cu), then a q row and S probabilities per warp.
    bf16: at the instance's D (:func:`bf16_instance_d`); up to S = 128,
    the 64-row Q tile, K and V (S rounded up to 16), in rows padded by 8
    values; in key blocks, whatever S, the 64-row Q tile and the ring's
    stages of K and V (bf16_blocks_smem_bytes).
    f32_tensor_core: at the kernel instance's sizes, max(d_k, d_v)
    rounded up to D = 32, 64, 128 or 256; with the keys whole (S and D up
    to 128), S rounded up to 16, 32, 64 or 128 rows, the 128-row Q tile in
    rows of D + 8 floats, then K and V split into tf32 hi and lo parts (K in
    rows of 2D + 8, V in pairs of rows of 4D + 8) where those fit, else as
    they are (rows of D + 8 and D + 4): f32tc_smem_bytes in
    csrc/cross_modal_attn.cu; in key blocks, whatever S, the Q tile, one key
    block split and the next as it is (rows of D): f32tc_blocks_smem_bytes.
    The copy width changes none of these."""
    if route is None:
        route = pick_route(dtype, S, dk, dv)
    if route in ("wide_f32", "wide_bf16"):
        return _wide_smem(torch.bfloat16 if route == "wide_bf16" else torch.float32)
    if route == "bf16":
        d = bf16_instance_d(dk, dv)
        if bf16_key_blocks(S, dk, dv):
            return _bf16_key_block_smem(d)
        return 2 * (d + 8) * (TILE_Q + 2 * (-(-S // 16) * 16))
    if route == "f32_tensor_core":
        d = f32_instance_d(dk, dv)
        if f32_key_blocks(S, dk, dv):
            return _f32_key_block_smem(d)
        rows = next(b for b in (16, 32, 64, 128) if S <= b)
        split = 4 * (F32_TILE_Q * (d + 8) + rows * (2 * d + 8) + rows // 2 * (4 * d + 8))
        return split if split <= SMEM_LIMIT else 4 * (F32_TILE_Q * (d + 8) + rows * (2 * d + 12))
    staged = 4 * (S * (dk + 1) + S * dv + WARPS * (dk + S))
    return staged if staged <= SMEM_LIMIT else 4 * WARPS * (dk + S)


def check_bf16_route(S: int, dk: int, dv: int, aligned: bool = True) -> None:
    """Raise where no attention function exists: S, d_k or d_v below 1.
    Every other bfloat16 call has a kernel (the bf16 kernels up to d = 128,
    their fill instance where d_k != d_v, d is off a multiple of 16 or the
    pointers off 16 bytes; the wide kernel past it), whatever the alignment
    of its element-aligned pointers."""
    if min(S, dk, dv) < 1:
        raise ValueError(f"cross_modal_attn: S, d_k and d_v must be at least 1; got S={S}, "
                         f"d_k={dk}, d_v={dv}")


def reset_launches() -> None:
    global launches, f32_key_block_launches, f32_narrow_launches, bf16_key_block_launches
    global bf16_fill_launches, wide_narrow_launches
    launches = f32_key_block_launches = f32_narrow_launches = bf16_key_block_launches = 0
    bf16_fill_launches = wide_narrow_launches = 0
    route_launches.update(dict.fromkeys(ROUTES, 0))
    bf16_mode_launches.update(dict.fromkeys(BF16_P_MODES, 0))


def p_mode(float32_p=None) -> str:
    """The bf16 mode of p: ``split_p`` where float32 probabilities are asked
    for (by default, as ``cm_attention.float32_probabilities()`` says), else
    ``round_p``."""
    if float32_p is None:
        float32_p = cm_attention.float32_probabilities()
    return "split_p" if float32_p else "round_p"


def attention_plain(q, k, v, num_heads: int, float32_p=None):
    """The kernel's function in plain PyTorch, output in q's dtype.  In
    float32, or with float32 probabilities (``split_p``), the function in
    float32; a bfloat16 call in the ``round_p`` mode is
    :func:`cm_attention.mha_attention` on its bfloat16 inputs, as the JAX
    package's default computes it: logits of bf16 values and the softmax in
    float32, p cast to bf16, p·v a bf16 product."""
    if q.dtype != torch.float32 and p_mode(float32_p) == "round_p":
        return cm_attention.mha_attention(q, k, v, num_heads)
    out = cm_attention.mha_attention(q.float(), k.float(), v.float(), num_heads)
    return out.to(q.dtype)


@functools.cache
def _entry():
    """The kernel's C entry, its argument types set once."""
    fn = _build.load("cross_modal_attn").cross_modal_attn
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return fn


def cross_modal_attn_cuda(q, k, v, num_heads: int):
    """Launch the kernel on CUDA tensors of one dtype (float32 or bfloat16),
    by the route :func:`pick_route` picks, bfloat16 in the mode of p that
    :func:`p_mode` reads."""
    global launches, f32_key_block_launches, f32_narrow_launches, bf16_key_block_launches
    global bf16_fill_launches, wide_narrow_launches
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"cross_modal_attn: expected CUDA tensors, got {device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cross_modal_attn: unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != device or t.dtype != q.dtype:
            raise ValueError(f"cross_modal_attn: {name} must be {q.dtype} on "
                             f"{device}, got {t.dtype} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"cross_modal_attn: {name} must be a contiguous "
                             f"(N, L, h*d) tensor, got {tuple(t.shape)}")
    N, Lq, Dq = q.shape
    S = k.shape[1]
    Dv = v.shape[-1]
    if (k.shape[0] != N or v.shape[:2] != k.shape[:2] or k.shape[-1] != Dq
            or Dq % num_heads or Dv % num_heads or S < 1):
        raise ValueError(
            f"cross_modal_attn: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit {num_heads} heads")
    dk, dv = Dq // num_heads, Dv // num_heads
    if any(t.data_ptr() % t.element_size() for t in (q, k, v)):
        raise ValueError("cross_modal_attn: q, k and v must be aligned to their element size")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    route = pick_route(q.dtype, S, dk, dv, aligned)
    code, narrow, mode = ROUTES[route], False, None
    if q.dtype == torch.bfloat16:
        mode = p_mode()
    if route == "f32_tensor_core":
        narrow = f32_narrow_copies(dk, dv, aligned)
        if f32_key_blocks(S, dk, dv):
            code = F32_KEY_BLOCKS
    elif route == "bf16":
        narrow = bf16_fill(dk, dv, aligned)
        if bf16_key_blocks(S, dk, dv, aligned):
            code = BF16_KEY_BLOCKS
    elif route != "f32_cuda_core":
        narrow = wide_narrow_copies(q.dtype, dk, dv, aligned)

    fn = _entry()
    out = torch.empty((N, Lq, Dv), device=device, dtype=q.dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N,
                 Lq, S, num_heads, dk, dv, code, int(narrow), int(mode == "round_p"), stream)
    if err != 0:
        raise RuntimeError(f"cross_modal_attn: CUDA error {err} at launch ({route})")
    launches += 1
    route_launches[route] += 1
    if mode is not None:
        bf16_mode_launches[mode] += 1
    if route == "f32_tensor_core":
        f32_narrow_launches += narrow
    elif route == "bf16":
        bf16_fill_launches += narrow
    elif route != "f32_cuda_core":
        wide_narrow_launches += narrow
    if code == F32_KEY_BLOCKS:
        f32_key_block_launches += 1
    elif code == BF16_KEY_BLOCKS:
        bf16_key_block_launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return cross_modal_attn_cuda(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad(), record_function("cross_modal_attn.backward_replay"):
            out = attention_plain(q, k, v, ctx.num_heads, float32_p=False)
            return (*torch.autograd.grad(out, (q, k, v), g), None)


def fused_cross_modal_attention(q, k, v, num_heads: int):
    """No-mask MHA core: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads)
    return _FusedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), num_heads)
