"""Fused LSTM sequence: the CUDA kernel ``csrc/lstm_seq.cu``, its wrapper,
its plain version and its launch counter.

Counterpart of robo_vln_tpu/ops/pallas_lstm.py, with the same API:
``lstm_sequence_fused(x, h0, c0, masks, w_ih, w_hh, b)``.  The input
projection ``x·W_ih + b`` of every step stays one ``torch.matmul`` outside the
kernel; the kernel runs the masked recurrence of the whole window in one
launch, in float32.

One difference from the JAX package, on purpose: there ``fused_lstm_sequence``
is a ``custom_vjp`` whose primal body is the scan, so the Pallas kernel ran
only under differentiation and inference ran the scan.  Here every call on a
CUDA tensor launches the kernel, the forward pass included.  It computes the
same function.

Dispatch is by where the tensors lie: on the CPU the plain version
(:func:`ops.rnn.lstm_recurrence`) runs; on a CUDA device the kernel launches,
or the wrapper raises.  The backward pass replays the plain version, as the
JAX custom VJP does (pallas_lstm.py:164-167).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rnn import lstm_recurrence

launches = 0  # kernel launches since the last reset

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
BATCH_TILE = 8  # kBatchTile of csrc/lstm_seq.cu


def reset_launches() -> None:
    global launches
    launches = 0


def _units_per_block(H: int, n_sm: int) -> int:
    """Hidden units per block: the fewest that keep the grid within one block
    per SM (the cooperative launch needs the whole grid co-resident)."""
    for units in range(1, H + 1):
        if H % units == 0 and H // units <= n_sm:
            return units
    return H


def smem_bytes(H: int, units: int) -> int:
    """Shared memory of one block (lstm_seq_smem_bytes in the source)."""
    return 4 * (4 * units * H + BATCH_TILE * H + BATCH_TILE * 4 * units)


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"lstm_seq: {name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lstm_seq: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lstm_seq: {name} must be contiguous")


def lstm_seq_cuda(gates_x, masks, h0, c0, w_hh):
    """Launch the kernel.  gates_x (T, B, 4H), masks (T, B), h0/c0 (B, H),
    w_hh (H, 4H), all float32 on one CUDA device."""
    global launches
    T, B, four_h = gates_x.shape
    H = four_h // 4
    device = gates_x.device
    if device.type != "cuda":
        raise ValueError(f"lstm_seq: expected CUDA tensors, got {device}")
    if T < 1 or B < 1 or four_h != 4 * H:
        raise ValueError(f"lstm_seq: bad gates_x shape {tuple(gates_x.shape)}")
    # (4H, H): no copy when w_hh is the transposed view of weight_hh_l0
    w_hh_t = w_hh.t().contiguous()
    for name, t, shape in (
        ("gates_x", gates_x, (T, B, 4 * H)), ("masks", masks, (T, B)),
        ("h0", h0, (B, H)), ("c0", c0, (B, H)), ("w_hh^T", w_hh_t, (4 * H, H)),
    ):
        _check(name, t, shape, device)

    lib = _build.load("lstm_seq")
    fn = lib.lstm_seq_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    units = _units_per_block(H, n_sm)
    if smem_bytes(H, units) > SMEM_LIMIT:
        raise ValueError(f"lstm_seq: H={H} needs {smem_bytes(H, units)} bytes of "
                         f"shared memory a block, more than {SMEM_LIMIT}")

    outs = torch.empty((T, B, H), device=device, dtype=torch.float32)
    hT = torch.empty((B, H), device=device, dtype=torch.float32)
    cT = torch.empty((B, H), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(gates_x.data_ptr(), masks.data_ptr(), h0.data_ptr(),
                 c0.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
                 hT.data_ptr(), cT.data_ptr(), T, B, H, units, stream)
    if err == 1000:
        raise RuntimeError(
            f"lstm_seq: a grid of {H // units} blocks does not fit co-resident "
            f"on {n_sm} SMs, which the cooperative launch needs")
    if err != 0:
        raise RuntimeError(f"lstm_seq: CUDA error {err} at launch")
    launches += 1
    return outs, hT, cT


class _FusedLSTM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_x, masks, h0, c0, w_hh):
        ctx.save_for_backward(gates_x, masks, h0, c0, w_hh)
        return lstm_seq_cuda(gates_x, masks, h0, c0, w_hh)

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        inputs = [t.detach().requires_grad_(t.dtype.is_floating_point)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = lstm_recurrence(*inputs)
        want = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, want, (g_outs, g_hT, g_cT),
                                         allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_lstm_sequence(gates_x, masks, h0, c0, w_hh):
    """(outs (T, B, H), hT, cT): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if gates_x.device.type == "cpu":
        return lstm_recurrence(gates_x, masks, h0, c0, w_hh)
    f32 = [t.float().contiguous() for t in (gates_x, masks, h0, c0)]
    return _FusedLSTM.apply(*f32, w_hh.float())


def lstm_sequence_fused(x, h0, c0, masks, w_ih, w_hh, b):
    """Drop-in for ops.rnn.lstm_sequence with the fused recurrent core.
    x (T, B, D), masks (T, B), w_ih (D, 4H), w_hh (H, 4H), b (4H,)."""
    gates_x = torch.matmul(x, w_ih) + b
    outs, hT, cT = fused_lstm_sequence(gates_x, masks, h0, c0, w_hh)
    return outs, (hT, cT)
