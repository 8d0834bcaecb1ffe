"""Fused cross-modal attention: the CUDA kernel ``csrc/cross_modal_attn.cu``,
its wrapper, its plain version and its launch counter.

Counterpart of robo_vln_tpu/ops/pallas_attention.py: per (example, head),
``softmax(q·kᵀ/√d_k)·v`` with no mask, the output in q's dtype.  q (N, Lq,
h·d_k), k (N, S, h·d_k), v (N, S, h·d_v) -> (N, Lq, h·d_v); the kernel
addresses the heads by stride, so there are no transposes around the call.
Three routes, picked before the launch by :func:`pick_route` from the dtype
and the sizes; a call that no route takes raises there, before any launch:

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
* ``f32_cuda_core``: float32, everything on the CUDA cores, for d_k or d_v
  above 256 only: K and V staged in shared memory where they fit, else read
  in place (:func:`smem_bytes`).  It refuses d_k + S > 7264.
* ``bf16``: both products on the tensor cores, the softmax in float32, the
  probabilities p in one of two modes (:data:`BF16_P_MODES`, counted apart
  in :data:`bf16_mode_launches`), picked by
  ``cm_attention.float32_probabilities()``: ``round_p`` (the default, the
  JAX package's default XLA attention) rounds p to bf16 once before p·v;
  ``split_p`` (JAX's ``TPU.PALLAS_ATTENTION`` on, its Pallas kernel's
  float32 p) keeps p to about 16 bits (``p_hi + p_lo``), so the only
  rounding left against the float32 function is that of the bf16 output.
  It takes
  d_k = d_v, a multiple of 16 up to 128, any S >= 1, and pointers aligned to
  16 bytes (:func:`check_bf16_route`).  Up to S = 128 one kernel holds a
  head's keys whole; past it another streams them through a ring of
  :data:`BF16_STAGES` key blocks of :data:`BF16_KEY_CHUNKS` 16-key chunks
  with an online softmax against a lazy row max (the C entry's code
  :data:`BF16_KEY_BLOCKS`, counted apart in :data:`bf16_key_block_launches`).

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

ROUTES = {"f32_cuda_core": 0, "bf16": 1, "f32_tensor_core": 2}  # codes of the C entry
launches = 0  # kernel launches since the last reset
route_launches = dict.fromkeys(ROUTES, 0)  # the same, by route
f32_key_block_launches = 0  # of f32_tensor_core's, those in key blocks (f32_key_blocks)
f32_narrow_launches = 0  # of f32_tensor_core's, those copying one float at a time
F32_KEY_BLOCKS = 3  # code of the C entry for f32_tensor_core's key blocks
bf16_key_block_launches = 0  # of bf16's, those past BF16_WHOLE_S, in key blocks
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
MAX_D = 128  # the largest head size of the bf16 kernels


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


def _bf16_key_block_smem(d: int) -> int:
    """bf16_blocks_smem_bytes: the Q tile and the ring's stages of K and V,
    in rows of d + 8 values."""
    return 2 * (d + 8) * (16 * BF16_BLOCK_WARPS + 2 * BF16_STAGES * 16 * BF16_KEY_CHUNKS)


def pick_route(dtype, S: int, dk: int, dv: int, aligned: bool = True) -> str:
    """The kernel a call launches, decided before the launch, never after a
    failure: bf16 for bfloat16 (:func:`check_bf16_route` raises where it
    does not take the sizes or the pointers); in float32 the tensor-core
    kernels wherever they take the sizes (d_k and d_v up to 256, either
    alignment), else (d above 256) the CUDA-core kernel, which raises where
    even its q rows and probabilities do not fit in shared memory."""
    if dtype == torch.bfloat16:
        check_bf16_route(S, dk, dv, aligned)
        return "bf16"
    if tensor_core_f32_takes(S, dk, dv):
        return "f32_tensor_core"
    need = smem_bytes(S, dk, dv, route="f32_cuda_core")
    if need > SMEM_LIMIT:
        raise ValueError(f"cross_modal_attn: S={S}, d_k={dk}, d_v={dv} need {need} "
                         "bytes of shared memory a block")
    return "f32_cuda_core"


def smem_bytes(S: int, dk: int, dv: int, dtype=torch.float32, route=None) -> int:
    """Shared memory of one block of ``route`` (by default bf16 for
    bfloat16, else the float32 kernel that takes the sizes).
    f32_cuda_core: K (padded rows) and V where they fit (f32_smem_bytes in
    csrc/cross_modal_attn.cu), then a q row and S probabilities per warp.
    bf16: up to S = 128, the 64-row Q tile, K and V (S rounded up to 16),
    in rows padded by 8 values; past it, whatever S, the 64-row Q tile and
    the ring's stages of K and V (bf16_blocks_smem_bytes).
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
        route = ("bf16" if dtype == torch.bfloat16 else "f32_tensor_core"
                 if tensor_core_f32_takes(S, dk, dv) else "f32_cuda_core")
    if route == "bf16":
        if S > BF16_WHOLE_S:
            return _bf16_key_block_smem(dk)
        return 2 * (dk + 8) * (TILE_Q + 2 * (-(-S // 16) * 16))
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
    """Raise unless the bfloat16 kernel takes these sizes and pointers."""
    if not (dk == dv and dk % 16 == 0 and 16 <= dk <= MAX_D and S >= 1):
        raise ValueError(
            f"cross_modal_attn: the bfloat16 kernel takes d_k = d_v, a multiple "
            f"of 16 up to {MAX_D}, and any S >= 1; got S={S}, d_k={dk}, d_v={dv}")
    if not aligned:
        raise ValueError("cross_modal_attn: q, k and v must be aligned to "
                         "16 bytes for the bfloat16 kernel")


def reset_launches() -> None:
    global launches, f32_key_block_launches, f32_narrow_launches, bf16_key_block_launches
    launches = f32_key_block_launches = f32_narrow_launches = bf16_key_block_launches = 0
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
    if route == "f32_tensor_core":
        narrow = f32_narrow_copies(dk, dv, aligned)
        if f32_key_blocks(S, dk, dv):
            code = F32_KEY_BLOCKS
    elif route == "bf16":
        mode = p_mode()
        if S > BF16_WHOLE_S:
            code = BF16_KEY_BLOCKS

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
    f32_narrow_launches += narrow
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
