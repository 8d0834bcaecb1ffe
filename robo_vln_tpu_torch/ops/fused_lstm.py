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
or the wrapper raises (:func:`check_shape`, before any launch: H off a
multiple of 4 or above 1024, or more than 8 hidden units a block to keep the
grid within one block an SM).  The grid has ceil(H / units) blocks, so H
need not divide evenly.

The backward pass is a kernel too, in the same source
(:func:`lstm_seq_backward_cuda`, in the profiler range
``lstm_seq.backward``): it computes what the JAX custom VJP gets by
differentiating its scan (pallas_lstm.py:164-167), the gradient with
respect to gates_x, masks, h0, c0 and w_hh.  Around the kernel, which runs
the reverse recurrence, :func:`reverse_pass` recomputes the gates of all
steps in one product before it and forms d_w_hh in one product after it;
the masks' gradient is formed only when asked.  Its plain version is
:func:`ops.rnn.lstm_recurrence_backward`.  Two kernels run the reverse
recurrence (:data:`BACKWARD_KERNELS`): ``partials``, the route
(:data:`BACKWARD_KERNEL`), exchanges each step's partial sums of dh~ over
each block's columns of W_hh; ``dg_exchange`` exchanges each step's whole
dg, and launches only where the route is set to it, to compare the two.
Both count in ``backward_launches`` and, by kernel, in
``backward_kernel_launches``.  The wrapper raises before any launch where
:func:`check_backward_shape` refuses.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.profiler import record_function

from ..utils.device import float32_exact
from . import _build
from .rnn import lstm_recurrence

launches = 0  # forward kernel launches since the last reset
backward_launches = 0  # backward kernel launches since the last reset
BACKWARD_KERNELS = ("partials", "dg_exchange")
BACKWARD_KERNEL = "partials"  # the backward's route
backward_kernel_launches = dict.fromkeys(BACKWARD_KERNELS, 0)  # the same, by kernel

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
WARPS = 8  # kWarps of csrc/lstm_seq.cu
TASK_BATCH = 2  # kTaskBatch: batch rows of one warp task
TASKS_PER_WARP = 16  # batch pairs a warp runs: one cell a lane, two a pair
MAX_H = 1024  # 32 lanes x 8 chunks of 4 values of W_hh's rows in registers
MAX_UNITS = 8  # kMaxUnits: units a block of the partials kernel
# the grid the partials kernel aims for: fewer blocks cut the partials each
# step stores and reads (blocks·B·H words), more cut each block's product
# (B·H·4·units multiply-adds); at H=512 on the H100, 64 blocks of 8 units
# took 0.1107 ms a call where 128 of 4 took 0.1287 (scripts/lstm_backward_probe.py)
BACKWARD_BLOCKS = 64
NOT_CO_RESIDENT = 1000  # kNotCoResident

# device index -> (int64 workspace of the h exchange, the stream of its last launch)
_workspaces: dict = {}
_private = []  # the workspace of private_workspace's innermost block, if any


def reset_launches() -> None:
    global launches, backward_launches
    launches = backward_launches = 0
    backward_kernel_launches.update(dict.fromkeys(BACKWARD_KERNELS, 0))


def _units_per_block(H: int, n_sm: int) -> int:
    """Hidden units per block: the fewest that keep the grid of
    ceil(H / units) blocks within one block per SM (the cooperative launch
    needs the whole grid co-resident)."""
    return -(-H // n_sm)


def backward_units_per_block(H: int, n_sm: int, kernel=None) -> int:
    """Hidden units per block of the backward: the forward's for
    ``dg_exchange``; for ``partials`` enough for a grid of about
    BACKWARD_BLOCKS blocks, at least the forward's and at most MAX_UNITS."""
    units = _units_per_block(H, n_sm)
    if _kernel(kernel) == "partials":
        units = min(MAX_UNITS, max(units, -(-H // BACKWARD_BLOCKS)))
    return units


def smem_bytes(H: int, B: int) -> int:
    """Shared memory of one block (lstm_seq_smem_bytes in the source): two
    buffers of h, B rounded up to TASK_BATCH rows."""
    b_pad = -(-B // TASK_BATCH) * TASK_BATCH
    return 4 * 2 * b_pad * H


def _kernel(kernel):
    kernel = BACKWARD_KERNEL if kernel is None else kernel
    if kernel not in BACKWARD_KERNELS:
        raise ValueError(f"lstm_seq backward: no kernel {kernel!r}")
    return kernel


def backward_smem_bytes(H: int, B: int, kernel=None) -> int:
    """Shared memory of one block of the backward: for ``partials``
    (lstm_seq_backward_partials_smem_bytes in the source) the block's cells'
    dg, two buffers of (B, 4 gates, MAX_UNITS) floats; for ``dg_exchange``
    (lstm_seq_backward_smem_bytes) two buffers of the whole dg, rows of 4H,
    B rounded up to TASK_BATCH rows."""
    if _kernel(kernel) == "partials":
        return 4 * 2 * B * 4 * MAX_UNITS
    return smem_bytes(4 * H, B)


def partials_lanes(units: int) -> int:
    """Lanes of one unit in the partials kernel's exchange: 32 over the
    units a block rounded up to a power of 2."""
    return 32 // (1 << (units - 1).bit_length())


def _most_rows(row: int, units: int) -> int:
    """The most batch rows one launch takes: 16 batch pairs a warp, and two
    buffers of ``row`` floats a batch row within a block's shared memory."""
    by_tasks = TASK_BATCH * TASKS_PER_WARP * (WARPS // units)
    by_smem = SMEM_LIMIT // (4 * 2 * row) // TASK_BATCH * TASK_BATCH
    return min(by_tasks, by_smem)


def max_batch(H: int, units: int) -> int:
    """The most batch rows one forward launch takes (rows of h)."""
    return _most_rows(H, units)


def max_backward_batch(H: int, units: int, kernel=None) -> int:
    """The most batch rows one backward launch takes: for ``partials`` an
    owner lane a cell, partials_lanes(units) rows in each warp; for
    ``dg_exchange`` the forward's limit with rows of dg (4H)."""
    if _kernel(kernel) == "partials":
        return WARPS * partials_lanes(units)
    return _most_rows(4 * H, units)


def _check_grid(what: str, H: int, units: int) -> None:
    if H % 4 or H > MAX_H:
        raise ValueError(f"{what}: the kernel holds W_hh's rows in 16-byte "
                         f"chunks, at most {MAX_H // 128} a lane, and takes H a "
                         f"multiple of 4 up to {MAX_H}; got H={H}")
    if units > WARPS:
        raise ValueError(f"{what}: H={H} needs {units} units a block, more "
                         f"than its {WARPS} warps")


def check_shape(B: int, H: int, units: int) -> None:
    """Raise unless one launch takes batch B and hidden size H at this many
    units a block."""
    _check_grid("lstm_seq", H, units)
    if B > max_batch(H, units):
        raise ValueError(f"lstm_seq: one launch takes at most {max_batch(H, units)} "
                         f"batch rows at H={H} and {units} units a block, got B={B}")


def check_backward_shape(B: int, H: int, units: int, kernel=None) -> None:
    """Raise unless one launch of the backward takes batch B and hidden
    size H at this many units a block: the forward's grid, with its own
    rows (:func:`max_backward_batch`)."""
    _check_grid("lstm_seq backward", H, units)
    most = max_backward_batch(H, units, kernel)
    if B > most:
        raise ValueError(f"lstm_seq backward: one launch takes at most {most} batch rows "
                         f"at H={H} and {units} units a block, got B={B}")


def _equal_slices(B: int, most: int) -> list:
    n = -(-B // most)
    size = -(-B // n)
    return [(b0, min(b0 + size, B)) for b0 in range(0, B, size)]


def batch_slices(B: int, H: int, units: int) -> list:
    """Rows [b0, b1) of each launch: the batch rows are independent, so a
    batch larger than one launch takes runs as launches over equal slices."""
    return _equal_slices(B, max_batch(H, units))


def backward_batch_slices(B: int, H: int, units: int, kernel=None) -> list:
    """The same for the backward."""
    return _equal_slices(B, max_backward_batch(H, units, kernel))


def by_rows(fn, slices, gates_x, masks, h0, c0, w_hh):
    """fn's (outs, hT, cT) over each slice [b0, b1) of batch rows, joined."""
    parts = [fn(gates_x[:, b0:b1].contiguous(), masks[:, b0:b1].contiguous(),
                h0[b0:b1], c0[b0:b1], w_hh) for b0, b1 in slices]
    return tuple(torch.cat(p, dim=p[0].dim() - 2) for p in zip(*parts))


@functools.cache
def _units(device_index: int, H: int):
    """(units a block, SM count) on one device."""
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return _units_per_block(H, n_sm), n_sm


def _backward_units(device_index: int, H: int, kernel=None):
    """(units a block of a backward kernel, SM count) on one device."""
    n_sm = _units(device_index, H)[1]
    return backward_units_per_block(H, n_sm, kernel), n_sm


@functools.cache
def _entry():
    """The kernel's C entry, its argument types set once."""
    fn = _build.load("lstm_seq").lstm_seq_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


@functools.cache
def _backward_entry(kernel: str):
    """The C entry of one backward kernel."""
    lib = _build.load("lstm_seq")
    fn = lib.lstm_seq_backward_partials_f32 if kernel == "partials" else lib.lstm_seq_backward_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


@functools.cache
def _exchange_entry(name: str = "lstm_seq_exchange"):
    """The C entry of a grid running nothing but its exchange:
    lstm_seq_exchange (the forward's), lstm_seq_backward_exchange or
    lstm_seq_backward_partials_exchange."""
    fn = getattr(_build.load("lstm_seq"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def workspace_words(B: int, H: int) -> int:
    """Words of a workspace that takes a forward launch over (B, H)."""
    return 2 + 2 * B * H


def make_workspace(device, B: int, H: int) -> torch.Tensor:
    """A workspace of its own for the forward launches over (B, H), zeroed,
    for :func:`private_workspace`."""
    return torch.zeros(workspace_words(B, H), device=device, dtype=torch.int64)


@contextlib.contextmanager
def private_workspace(ws: torch.Tensor):
    """Route every launch in the block through ``ws`` (from
    :func:`make_workspace`), not through the device's shared workspace.  A
    CUDA graph bakes in the pointer it captured: the shared workspace is
    reallocated when a larger launch grows it (the backward's asks for
    B·4H words), and the graph would replay into freed memory.  A private
    one is never grown (a launch it is too small for raises) nor handed
    between streams, so nothing in the block waits on an event from outside
    a capture; its epoch protocol runs alone, launch after launch, as the
    shared one's does."""
    _private.append(ws)
    try:
        yield ws
    finally:
        _private.pop()


def _workspace(device, stream, B: int, H: int) -> torch.Tensor:
    """The exchange's workspace of one device: [epoch, blocks done, two
    buffers of B·H tagged words], grown to the largest B·H asked for (the
    backward asks for B·4H: it exchanges dg).  Both kernels use it and
    advance its epoch by their steps.  Zeroed when made, then kept: each
    launch leaves it ready for the next.  Launches on one stream are
    ordered; one on another stream first waits for the stream of the last.
    Inside :func:`private_workspace` the block's workspace is used instead."""
    if _private:
        ws = _private[-1]
        if ws.device != device or ws.numel() < workspace_words(B, H):
            raise ValueError(f"lstm_seq: the private workspace ({ws.numel()} words on "
                             f"{ws.device}) does not take a launch over B={B}, H={H} "
                             f"on {device}")
        return ws
    ws, last = _workspaces.get(device.index, (None, stream))
    if last != stream:
        stream.wait_stream(last)
        ws.record_stream(stream)
    if ws is None or ws.numel() < 2 + 2 * B * H:
        ws = torch.zeros(2 + 2 * B * H, device=device, dtype=torch.int64)
    _workspaces[device.index] = ws, stream
    return ws


def _check(name, t, shape, device, contiguous=True):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"lstm_seq: {name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lstm_seq: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"lstm_seq: {name} must be contiguous")


def _raise_on(err: int, H: int, units: int, n_sm: int) -> None:
    if err == NOT_CO_RESIDENT:
        raise RuntimeError(
            f"lstm_seq: a grid of {-(-H // units)} blocks does not fit co-resident "
            f"on {n_sm} SMs, which the cooperative launch needs")
    if err != 0:
        raise RuntimeError(f"lstm_seq: CUDA error {err} at launch")


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
    units, n_sm = _units(device.index, H)
    check_shape(1, H, units)
    if w_hh_t.data_ptr() % 16:  # read in 16-byte chunks
        raise ValueError("lstm_seq: w_hh must be aligned to 16 bytes")

    slices = batch_slices(B, H, units)
    if len(slices) > 1:
        return by_rows(lstm_seq_cuda, slices, gates_x, masks, h0, c0, w_hh)

    fn = _entry()
    outs = torch.empty((T, B, H), device=device, dtype=torch.float32)
    hT = torch.empty((B, H), device=device, dtype=torch.float32)
    cT = torch.empty((B, H), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        ws = _workspace(device, stream, B, H)
        err = fn(gates_x.data_ptr(), masks.data_ptr(), h0.data_ptr(),
                 c0.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
                 hT.data_ptr(), cT.data_ptr(), ws.data_ptr(), T, B, H, units,
                 device.index, stream.cuda_stream)
    _raise_on(err, H, units, n_sm)
    launches += 1
    return outs, hT, cT


def exchange_floor_cuda(T: int, B: int, H: int, device) -> None:
    """Launch the kernel's grid for (B, H) running T steps of nothing but the
    h exchange: the floor that the exchange puts under a step.  A measuring
    aid; it computes nothing and is not counted in ``launches``."""
    device = torch.device(device)
    units, n_sm = _units(device.index, H)
    check_shape(B, H, units)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        ws = _workspace(device, stream, B, H)
        err = _exchange_entry()(ws.data_ptr(), T, B, H, units, device.index,
                                stream.cuda_stream)
    _raise_on(err, H, units, n_sm)


def _backward_words(kernel: str, B: int, H: int, units: int) -> int:
    """Words of one of the workspace's two buffers that a backward kernel
    uses: the whole dg (B·4H), or every block's partials (blocks·B·H)."""
    return -(-H // units) * B * H if kernel == "partials" else B * 4 * H


def backward_exchange_floor_cuda(T: int, B: int, H: int, device, kernel=None) -> None:
    """Launch a backward kernel's grid for (B, H) running T stages of
    nothing but its exchange (:data:`BACKWARD_KERNEL` by default): the floor
    that the exchange puts under a reverse step.  A measuring aid; it
    computes nothing and is not counted in the launches."""
    kernel = _kernel(kernel)
    device = torch.device(device)
    units, n_sm = _backward_units(device.index, H, kernel)
    check_backward_shape(B, H, units, kernel)
    name = ("lstm_seq_backward_partials_exchange" if kernel == "partials"
            else "lstm_seq_backward_exchange")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        ws = _workspace(device, stream, 1, _backward_words(kernel, B, H, units))
        err = _exchange_entry(name)(ws.data_ptr(), T, B, H, units, device.index,
                                    stream.cuda_stream)
    _raise_on(err, H, units, n_sm)


def reverse_pass(launch, slices, gates_x, masks, h0, c0, w_hh, outs, g_outs, g_hT,
                 g_cT, masks_grad):
    """The backward around its kernel, (d_gates_x, d_masks, d_h0, d_c0,
    d_w_hh) as :func:`ops.rnn.lstm_recurrence_backward` gives them.  The
    gates of all T steps, gx + h~·W_hh with h~_t = m_t h_{t-1} read from
    ``outs``, come from one product; ``launch(gates, masks, c0, w_hh,
    g_outs, g_hT, g_cT, masks_grad)`` runs the reverse recurrence over each
    slice [b0, b1) of batch rows and returns (d_gates, d_h0, d_c0, c_t, dh~,
    dc~) of those rows (the last two None unless ``masks_grad``); the slices
    are joined, and d_w_hh = Σ h~ᵀ·d_gates comes from one product over the
    joined rows, never from per-slice sums.  The masks' gradient is
    Σ_H (h_{t-1} dh~ + c_{t-1} dc~).  Both products in float32, TF32 off.
    ``w_hh`` (H, 4H) goes to ``launch`` as it is given (the agent's is the
    transposed view of weight_hh_l0), and the launch makes the layout its
    kernel reads."""
    T, B, four_h = gates_x.shape
    H = four_h // 4
    h_prev = torch.cat([h0[None], outs[:-1]])
    h_tilde = h_prev * masks[..., None]
    with float32_exact(torch.float32):  # gx + h~·W_hh, the sum in the product's epilogue
        gates = torch.addmm(gates_x.reshape(T * B, four_h), h_tilde.reshape(T * B, H),
                            w_hh).view(T, B, four_h)
    parts = [launch(gates[:, b0:b1].contiguous(), masks[:, b0:b1].contiguous(), c0[b0:b1],
                    w_hh, g_outs[:, b0:b1].contiguous(), g_hT[b0:b1], g_cT[b0:b1],
                    masks_grad) for b0, b1 in slices]
    d_gates, d_h0, d_c0, cs, d_h_tilde, d_c_tilde = parts[0] if len(parts) == 1 else (
        None if p[0] is None else torch.cat(p, dim=p[0].dim() - 2) for p in zip(*parts))
    with float32_exact(torch.float32):
        d_w_hh = h_tilde.reshape(T * B, H).t() @ d_gates.reshape(T * B, four_h)
    d_masks = None
    if masks_grad:
        c_prev = torch.cat([c0[None], cs[:-1]])
        d_masks = (h_prev * d_h_tilde + c_prev * d_c_tilde).sum(-1)
    return d_gates, d_masks, d_h0, d_c0, d_w_hh


def _backward_launch(gates, masks, c0, w_hh, g_outs, g_hT, g_cT, masks_grad):
    """One launch of the backward kernel :data:`BACKWARD_KERNEL` over these
    batch rows (see :func:`reverse_pass`).  ``partials`` reads W_hh^T (4H, H),
    no copy when w_hh is the transposed view of weight_hh_l0; ``dg_exchange``
    reads W_hh's rows (H, 4H) in 16-byte chunks."""
    global backward_launches
    kernel = _kernel(None)
    T, B, four_h = gates.shape
    H = four_h // 4
    device = gates.device
    units, n_sm = _backward_units(device.index, H, kernel)
    check_backward_shape(B, H, units, kernel)
    w = w_hh.t().contiguous() if kernel == "partials" else w_hh.contiguous()
    if kernel == "dg_exchange" and w.data_ptr() % 16:  # its rows read in 16-byte chunks
        raise ValueError("lstm_seq backward: w_hh must be aligned to 16 bytes")

    def empty(*shape):
        return torch.empty(shape, device=device, dtype=torch.float32)

    d_gates, d_h0, d_c0, cs = empty(T, B, four_h), empty(B, H), empty(B, H), empty(T, B, H)
    d_h_tilde, d_c_tilde = (empty(T, B, H), empty(T, B, H)) if masks_grad else (None, None)
    ptrs = [None if t is None else t.data_ptr() for t in (
        gates, masks, c0, w, g_outs, g_hT, g_cT, d_gates, d_h0, d_c0, cs, d_h_tilde,
        d_c_tilde)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        ws = _workspace(device, stream, 1, _backward_words(kernel, B, H, units))
        err = _backward_entry(kernel)(*ptrs, ws.data_ptr(), T, B, H, units, device.index,
                                      stream.cuda_stream)
    _raise_on(err, H, units, n_sm)
    backward_launches += 1
    backward_kernel_launches[kernel] += 1
    return d_gates, d_h0, d_c0, cs, d_h_tilde, d_c_tilde


def lstm_seq_backward_cuda(gates_x, masks, h0, c0, w_hh, outs, g_outs, g_hT, g_cT,
                           masks_grad=True):
    """Launch the backward kernel: the gradient of :func:`lstm_seq_cuda` at
    the cotangents (g_outs, g_hT, g_cT), given its inputs and its ``outs``,
    as :func:`ops.rnn.lstm_recurrence_backward` computes it.  All float32 on
    one CUDA device; the cotangents may be strided or expanded (autograd's
    zeros).  A batch beyond one launch runs as launches over row slices."""
    T, B, four_h = gates_x.shape
    H = four_h // 4
    device = gates_x.device
    if device.type != "cuda":
        raise ValueError(f"lstm_seq backward: expected CUDA tensors, got {device}")
    if T < 1 or B < 1 or four_h != 4 * H:
        raise ValueError(f"lstm_seq backward: bad gates_x shape {tuple(gates_x.shape)}")
    g_outs, g_hT, g_cT = (t.contiguous() for t in (g_outs, g_hT, g_cT))
    for name, t, shape in (
        ("gates_x", gates_x, (T, B, 4 * H)), ("masks", masks, (T, B)),
        ("h0", h0, (B, H)), ("c0", c0, (B, H)),
        ("outs", outs, (T, B, H)), ("g_outs", g_outs, (T, B, H)),
        ("g_hT", g_hT, (B, H)), ("g_cT", g_cT, (B, H)),
    ):
        _check(name, t, shape, device)
    # any strides: each kernel's launch makes the layout it reads
    _check("w_hh", w_hh, (H, 4 * H), device, contiguous=False)
    units, _ = _backward_units(device.index, H)
    check_backward_shape(1, H, units)
    return reverse_pass(_backward_launch, backward_batch_slices(B, H, units), gates_x,
                        masks, h0, c0, w_hh, outs, g_outs, g_hT, g_cT, masks_grad)


class _FusedLSTM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_x, masks, h0, c0, w_hh):
        outs, hT, cT = lstm_seq_cuda(gates_x, masks, h0, c0, w_hh)
        ctx.save_for_backward(gates_x, masks, h0, c0, w_hh, outs)
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        with record_function("lstm_seq.backward"):
            grads = lstm_seq_backward_cuda(*ctx.saved_tensors, g_outs, g_hT, g_cT,
                                           masks_grad=ctx.needs_input_grad[1])
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


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
