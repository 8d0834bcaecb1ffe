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
  blocks (:func:`f32_block_keys`) with an online softmax (the C entry's
  code :data:`F32_KEY_BLOCKS`, counted apart in
  :data:`f32_key_block_launches`): at D = 128 and 256 on warpgroup MMA,
  blocks of 128 query rows and 128 columns of D, two blocks of a cluster
  at D = 256 (:func:`f32_block_cluster`); at D = 32 and 64 on mma.sync.
  Both copy 16 bytes at a time where q, k and v are aligned to 16 bytes and
  d_k and d_v are multiples of 4, else one float at a time
  (:func:`f32_narrow_copies`; those launches are also counted in
  :data:`f32_narrow_launches`).
* ``wide_f32`` and ``wide_bf16``: the wide-head kernels, for float32 with
  d_k or d_v above 256 and bfloat16 above 128, any S and alignment, one
  block per query tile and slice of d_v (:func:`wide_slices`: one slice,
  so one pass over d_v, up to 272 columns), the Q tile held with d_k whole
  up to :data:`WIDE_DK`.  In float32, warpgroup MMA (wgmma) in 3xTF32, a
  producer warpgroup staging Q, K and Vᵀ split into tf32 hi and lo parts in
  shared memory, keys in blocks of :data:`WIDE_F32_KEYS`; in bfloat16,
  bf16 mma.sync, 8 warps of 16 query rows over every column of the slice
  (128-row tiles), keys in blocks of :data:`WIDE_BF16_KEYS` through a ring of
  :data:`WIDE_BF16_STAGES`, p split into bf16 ``p_hi + p_lo`` in
  ``split_p``.  Pointers or d off the 16-byte copies
  (:func:`wide_narrow_copies`; counted in :data:`wide_narrow_launches`)
  take the narrow instance: one float a copy in float32, in bfloat16 the
  widest copy each tensor allows (:func:`bf16_copy_width`).
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
  to 16: :func:`bf16_instance_d`), each of q, k and v copied by the widest
  ``cp.async`` that its pointer and head size allow (16, 8 or 4 bytes, the
  source size cut at d), or by 16-byte loads of the aligned words that
  cover a row, shifted by the row's offset (:func:`bf16_copy_width`; the
  fill instance's and ``wide_bf16``'s launches by their narrowest copy in
  :data:`bf16_copy_launches`), the output in 16-byte stores wherever whole
  16-byte words of its rows lie.

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
wide_narrow_launches = 0  # of the wide kernels', those of the narrow instance
BF16_COPIES = ("16", "8", "4", "shifted")  # bf16_copy_width's 16, 8, 4 bytes and 0
bf16_copy_launches = dict.fromkeys(BF16_COPIES, 0)  # fill and wide_bf16, by narrowest copy
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
BF16_FILL_STAGES = 4  # kBf16FillStages: the same, of the fill instance
F32_TILE_Q = 128  # kF32Tile of csrc/cross_modal_attn.cu (f32_tensor_core route)
F32_WHOLE_S = 128  # the most keys f32_tensor_core holds whole; past it, key blocks
F32_WHOLE_MAX_D = 128  # the largest D f32_tensor_core holds whole; past it, key blocks
F32_MAX_D = 256  # the largest d_k and d_v of f32_tensor_core
F32_KEY_CHUNKS = 4  # kF32KeyChunks: 8-key chunks a key block, D = 32 and 64 (mma.sync)
F32_BLOCK_TILE = 128  # kF32WgTile: query rows of a block at D >= 128, two warpgroups of 64
F32_BLOCK_COLS = 128  # kF32WgCols: columns of d_k and d_v a block holds there
F32_BLOCK_KEYS = 32  # kF32WgKeys: keys of a key block there
MAX_D = 128  # the largest head size of the bf16 kernels; past it, the wide kernel
WIDE_TILE = 64  # kWideTile of csrc/cross_modal_attn.cu: query rows of a float32 block
WIDE_BF16_TILE = 128  # kWideBf16Tile: query rows of a bf16 block
WIDE_DK = 272  # kWideDk: the most d_k columns a block holds; past it, chunks of 272
WIDE_HALF = 136  # kWideHalf: the most d_v columns of a float32 wgmma N tile, two a slice
WIDE_BF16_WARPS = 8  # kWideBf16Warps: 16 query rows each, every column of the slice
WIDE_BF16_KEYS = 32  # kWideBf16Keys: keys of a bf16 key block
WIDE_BF16_STAGES = 4  # kWideBf16Stages: key blocks in the bf16 ring
WIDE_F32_KEYS = 16  # kWgKeys: keys of a float32 key block
WIDE_BF16_P_BITS = 16  # significant bits of p_hi + p_lo in wide_bf16's split_p
WIDEST_COPY = 16  # kWidestCopy: bytes of the widest bf16 copy
NARROWEST_COPY = 4  # kNarrowestCopy: of the narrowest; below it, shifted loads
SHIFTED_LOAD = 0  # kShiftedLoad: bf16_copy_width's code of a shifted load


def tensor_core_f32_takes(S: int, dk: int, dv: int) -> bool:
    """Whether the float32 tensor-core route takes these sizes: any d_k and
    d_v from 1 to 256 and any S >= 1 (from any float32 pointer)."""
    return S >= 1 and all(1 <= d <= F32_MAX_D for d in (dk, dv))


def f32_instance_d(dk: int, dv: int) -> int:
    """D of the float32 tensor-core instance: max(d_k, d_v) rounded up to
    32, 64, 128 or 256; the tiles are zero-filled past d_k and d_v."""
    return next(b for b in (32, 64, 128, 256) if max(dk, dv) <= b)


def f32_block_cluster(d: int) -> int:
    """Blocks of a cluster of the float32 key-block kernels at instance D =
    d: from D = 128 the warpgroup-MMA kernel's (f32_wg_cluster), each block
    holding 128 columns of d_k and of d_v, so 2 at D = 256; else 1."""
    return max(1, d // F32_BLOCK_COLS)


def f32_block_keys(d: int) -> int:
    """Keys of one float32 key block at instance D = d: kF32WgKeys from D =
    128, 8·kF32KeyChunks below."""
    return F32_BLOCK_KEYS if d >= F32_BLOCK_COLS else 8 * F32_KEY_CHUNKS


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
    """From D = 128 f32_wg_smem_bytes: one block's Q, K and Vᵀ tiles split
    into tf32 hi and lo (128 query rows, a key block's keys, 128 columns),
    the peer's partial logits of two key blocks in a cluster of two, and
    eight mbarriers.  Below, f32tc_blocks_smem_bytes: the 128-row Q tile,
    one key block split and the next one as it is."""
    if d >= F32_BLOCK_COLS:
        c, kb, w = f32_block_cluster(d), F32_BLOCK_KEYS, F32_BLOCK_COLS
        return 4 * (2 * F32_BLOCK_TILE * w + 4 * kb * w + 2 * (c - 1) * F32_BLOCK_TILE * kb) + 64
    kc = F32_KEY_CHUNKS
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
    """Slices of d_v of the wide kernels, one block each: ceil(d_v / 272),
    so one pass over d_v up to 272 columns."""
    return -(-dv // (2 * WIDE_HALF))


def wide_width(dv: int) -> int:
    """Columns of one slice: d_v over the slices, rounded up to 8."""
    per = -(-dv // wide_slices(dv))
    return -(-per // 8) * 8


def wide_narrow_copies(dtype, dk: int, dv: int, aligned: bool) -> bool:
    """Whether a wide call takes its kernel's narrow instance: as the
    float32 tensor-core kernels in float32 (d a multiple of 4), in bfloat16
    wherever a copy of q, k or v would be narrower than 16 bytes (d a
    multiple of 8 and 16-byte pointers otherwise)."""
    if dtype == torch.bfloat16:
        return not aligned or dk % 8 != 0 or dv % 8 != 0
    return f32_narrow_copies(dk, dv, aligned)


def bf16_copy_width(offset: int, d: int) -> int:
    """bf16_copy_width of csrc/cross_modal_attn.cu: the bytes of the copies
    of rows of d bf16 values whose tensor starts ``offset`` bytes past a
    16-byte boundary (rows heads·d values apart, a head d on): the widest
    of 16, 8 and 4 that divides both the offset and the row's 2d bytes,
    else :data:`SHIFTED_LOAD` (two aligned 16-byte words a chunk of 8
    values, shifted by the row's offset in its word)."""
    w = WIDEST_COPY
    while w >= NARROWEST_COPY:
        if offset % w == 0 and (2 * d) % w == 0:
            return w
        w //= 2
    return SHIFTED_LOAD


def bf16_narrowest_copy(q, k, v, dk: int, dv: int) -> str:
    """The key of :data:`bf16_copy_launches` that a bf16 call on q, k, v
    counts under: the narrowest of the three tensors' copies."""
    widths = [bf16_copy_width(t.data_ptr() % 16, d) for t, d in ((q, dk), (k, dk), (v, dv))]
    return "shifted" if SHIFTED_LOAD in widths else str(min(widths))


def _wide_smem(dtype) -> int:
    """Shared memory of one block of a wide kernel, whatever the sizes.
    bfloat16 (wide_bf16_smem_bytes): the 128-row Q tile and the ring's
    stages of K and V (32 keys each), in rows of 280 values.  float32
    (wide_f32_smem_bytes): Q's hi and lo parts (64 rows of 272), K's (16
    rows of 272), Vᵀ's (272 rows of 16) and six mbarriers."""
    if dtype == torch.bfloat16:
        return 2 * (WIDE_DK + 8) * (WIDE_BF16_TILE + 2 * WIDE_BF16_STAGES * WIDE_BF16_KEYS)
    return (4 * (2 * WIDE_TILE * WIDE_DK + 2 * WIDE_F32_KEYS * WIDE_DK
                 + 2 * 2 * WIDE_HALF * WIDE_F32_KEYS) + 6 * 8)


def _bf16_key_block_smem(d: int, fill: bool = False) -> int:
    """bf16_blocks_smem_bytes: the Q tile and the ring's stages of K and V
    (BF16_STAGES, the fill instance BF16_FILL_STAGES), in rows of d + 8
    values."""
    stages = BF16_FILL_STAGES if fill else BF16_STAGES
    return 2 * (d + 8) * (16 * BF16_BLOCK_WARPS + 2 * stages * 16 * BF16_KEY_CHUNKS)


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


def smem_bytes(S: int, dk: int, dv: int, dtype=torch.float32, route=None,
               aligned: bool = True) -> int:
    """Shared memory of one block of ``route`` (by default the route
    :func:`pick_route` picks).
    wide_f32, wide_bf16: whatever the sizes (:func:`_wide_smem`).
    f32_cuda_core: K (padded rows) and V where they fit (f32_smem_bytes in
    csrc/cross_modal_attn.cu), then a q row and S probabilities per warp.
    bf16: at the instance's D (:func:`bf16_instance_d`); up to S = 128,
    the 64-row Q tile, K and V (S rounded up to 16), in rows padded by 8
    values; in key blocks, whatever S, the 64-row Q tile and the ring's
    stages of K and V (bf16_blocks_smem_bytes; the fill instance, taken
    where :func:`bf16_fill` says so for ``aligned`` pointers, a stage
    more).
    f32_tensor_core: at the kernel instance's sizes, max(d_k, d_v)
    rounded up to D = 32, 64, 128 or 256; with the keys whole (S and D up
    to 128), S rounded up to 16, 32, 64 or 128 rows, the 128-row Q tile in
    rows of D + 8 floats, then K and V split into tf32 hi and lo parts (K in
    rows of 2D + 8, V in pairs of rows of 4D + 8) where those fit, else as
    they are (rows of D + 8 and D + 4): f32tc_smem_bytes in
    csrc/cross_modal_attn.cu; in key blocks, whatever S, from D = 128 a
    block's split Q, K and Vᵀ tiles of 128 columns and, at D = 256, the
    peer's partial logits (f32_wg_smem_bytes), below the Q tile, one key
    block split and the next as it is (f32tc_blocks_smem_bytes):
    :func:`_f32_key_block_smem`.  The copy width changes none of these."""
    if route is None:
        route = pick_route(dtype, S, dk, dv)
    if route in ("wide_f32", "wide_bf16"):
        return _wide_smem(torch.bfloat16 if route == "wide_bf16" else torch.float32)
    if route == "bf16":
        d = bf16_instance_d(dk, dv)
        if bf16_key_blocks(S, dk, dv, aligned):
            return _bf16_key_block_smem(d, bf16_fill(dk, dv, aligned))
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
    bf16_copy_launches.update(dict.fromkeys(BF16_COPIES, 0))
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
    if route == "wide_bf16" or (route == "bf16" and narrow):
        bf16_copy_launches[bf16_narrowest_copy(q, k, v, dk, dv)] += 1
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
