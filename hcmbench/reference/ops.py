"""Plain PyTorch building blocks of the benchmark's reference: products in a
chosen precision, norms, the masked LSTM, attention, the losses and the two
Adam updates.

Everything computes in float32.  ``Arith`` is the one switch of precision:
``Arith("float32")`` is exact (TF32 off, see :func:`exact_float32`);
``Arith("bfloat16")`` stores every tensor of the step's forward and backward
in bfloat16, the configurations' precision, a witness of what that
precision alone gives; ``Arith("float8")`` stores them in float8 e4m3, a
step below it: the control.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

FP8_MAX = 448.0  # largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class _Rounding(TorchDispatchMode):
    """Rounds the float32 output of every operation, forward and backward,
    that makes a new tensor (views and in-place updates pass as they are)."""

    def __init__(self, rounder):
        super().__init__()
        self.rounder = rounder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.name.endswith("_"):
            return out
        return tree_map(lambda t: self.rounder(t) if isinstance(t, torch.Tensor)
                        and t.dtype == torch.float32 else t, out)


def _to_bfloat16(x):
    return x.to(torch.bfloat16).float()


def _to_float8(x):
    """Float8 e4m3 with one scale a tensor (its largest magnitude to 448)."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX if x.numel() else x.new_ones(())
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """The reference's arithmetic: float32 throughout (TF32 off, see
    :func:`exact_float32`), or, inside :meth:`scope`, every new tensor of the
    forward and the backward rounded to bfloat16 or float8 e4m3 as it is
    made: a computation stored in that precision, its products accumulated
    and its norms taken in float32 within each operation."""

    ROUNDERS = {"float32": None, "bfloat16": _to_bfloat16, "float8": _to_float8}

    def __init__(self, precision: str = "float32"):
        if precision not in self.ROUNDERS:
            raise ValueError(f"precision {precision!r}: one of {sorted(self.ROUNDERS)}")
        self.precision = precision

    def scope(self):
        rounder = self.ROUNDERS[self.precision]
        return contextlib.nullcontext() if rounder is None else _Rounding(rounder)

    def operand(self, x):
        """A product's operand in the precision: the weights too are stored
        in it; the gradient passes the rounding as it stands."""
        x = x.float()
        rounder = self.ROUNDERS[self.precision]
        if rounder is None or x.device.type == "meta":
            return x
        return x + (rounder(x.detach()) - x).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.operand(x), self.operand(w), None if b is None else b.float())

    def conv(self, x, w, stride=1, padding=0):
        return F.conv2d(self.operand(x), self.operand(w), None, stride, padding)

    def matmul(self, a, b):
        return torch.matmul(self.operand(a), self.operand(b))


def layer_norm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps)


def dropout(x, rate, generator):
    """Each element kept with probability 1 - rate and scaled by 1 / (1 -
    rate); the keep mask is a float32 Bernoulli draw of x's shape from
    ``generator`` on x's device.  The identity without a generator."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def lstm(A: Arith, x, h, c, masks, w_ih, w_hh, b_ih, b_hh):
    """One-layer LSTM over x (T, B, D) with torch's gate order (i, f, g, o);
    the carry is zeroed where masks (T, B) is 0 before the step.  Returns
    (outputs (T, B, H), h, c)."""
    gates_x = A.linear(x, w_ih, b_ih + b_hh)
    outs = []
    for t in range(x.shape[0]):
        m = masks[t][:, None]
        h, c = h * m, c * m
        i, f, g, o = (gates_x[t] + A.linear(h, w_hh)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs), h, c


def multi_head_attention(A: Arith, q, k, v, heads):
    """softmax(q kᵀ / √d) v per head: q (N, Lq, h·d), k and v (N, S, h·d)."""
    n, lq, _ = q.shape
    s = k.shape[1]
    d = q.shape[-1] // heads
    qh = q.reshape(n, lq, heads, d).transpose(1, 2)
    kh = k.reshape(n, s, heads, d).transpose(1, 2)
    vh = v.reshape(n, s, heads, d).transpose(1, 2)
    p = torch.softmax(A.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return A.matmul(p, vh).transpose(1, 2).reshape(n, lq, heads * d)


def sinusoid_table(length, width, device):
    """Sine in the even columns, cosine in the odd ones, pair k at the
    frequency 10000^(-2k / width)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(width // 2, dtype=torch.float32, device=device)[None]
    angle = pos / torch.pow(10000.0, 2.0 * k / width)
    table = torch.zeros(length, width, device=device)
    table[:, 0::2] = torch.sin(angle)
    table[:, 1::2] = torch.cos(angle)
    return table


# -- losses ------------------------------------------------------------------------------

def velocity_mse(pred, target):
    """The prediction zeroed where the target is 0; the mean over every
    element."""
    return ((torch.where(target != 0.0, pred, 0.0) - target) ** 2).mean()


def stop_bce(logits, target):
    """Binary cross entropy with logits, a mean over the targets that are not
    -1."""
    valid = target != -1.0
    t = torch.where(valid, target, 0.0)
    per = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    return torch.where(valid, per, 0.0).sum() / valid.sum().clamp(min=1)


def subgoal_ce(logits, oracle):
    """Cross entropy against the labels oracle - 1, a mean over the rows whose
    oracle is not 0 (those rows' logits read as 0)."""
    keep = oracle != 0
    logits = torch.where(keep[:, None], logits, 0.0)
    nll = F.cross_entropy(logits, (oracle.long() - 1).clamp(min=0), reduction="none")
    return torch.where(keep, nll, 0.0).sum() / keep.sum().clamp(min=1)


# -- optimizers ---------------------------------------------------------------------------

BETAS = (0.9, 0.999)
EPS = 1e-8


class Adam:
    """Adam over a dict of leaves, the moments kept per leaf; with
    ``decoupled`` the weight decay multiplies the leaf by 1 - lr·wd before the
    update (AdamW), otherwise it is added to the gradient (L2)."""

    def __init__(self, weight_decay=0.0, decoupled=False):
        self.wd, self.decoupled = weight_decay, decoupled
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params, grads, lr):
        """params: {name: tensor}, updated in place; leaves without a
        gradient are left alone."""
        self.t += 1
        b1, b2 = BETAS
        for name, g in grads.items():
            p = params[name]
            if self.wd and not self.decoupled:
                g = g + self.wd * p
            m = self.m[name] = b1 * self.m.get(name, torch.zeros_like(p)) + (1 - b1) * g
            v = self.v[name] = b2 * self.v.get(name, torch.zeros_like(p)) + (1 - b2) * g * g
            if self.wd and self.decoupled:
                p.mul_(1 - lr * self.wd)
            denom = (v / (1 - b2 ** self.t)).sqrt() + EPS
            p.sub_(lr * (m / (1 - b1 ** self.t)) / denom)
