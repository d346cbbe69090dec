"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program. Every product runs in float32 with TF32
switched off (``fp32_mode``). ``Precision`` says how the inputs of each
matrix product are rounded first: ``"fp32"`` leaves them (the reference),
``"fp8"`` rounds both to float8 e4m3 with a scale per row of the
activations and per output column of the weights (the control: the
precision one step below the bfloat16 that the configurations state)."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

FP8_MAX = 448.0     # largest finite float8 e4m3 value


@contextlib.contextmanager
def fp32_mode():
    """Float32 products without TF32, restored on exit."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its absolute maximum mapped to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How a reference rounds the inputs of its matrix products."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight ``[in, out]`` (or ``[E, in, out]``) in float32."""
        w = w.float()
        return to_fp8(w, -2) if self.kind == "fp8" else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation ``[..., in]`` about to enter a product."""
        x = x.float()
        return to_fp8(x, -1) if self.kind == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` of an activation and a weight already passed through
        :meth:`weight`."""
        return self.act(x) @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, split-half form. x: [S, H, D]; positions: [S]."""
    D = x.shape[-1]
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (positions.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, *, window: int = 0, prec: Precision,
              q_block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention over one sequence, float32, blocks of
    ``q_block`` query rows. q: [S, Hq, D]; k, v: [S, Hkv, D]. Position t
    sees positions s <= t, and with ``window`` only s > t - window."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    kk = prec.act(k).permute(1, 2, 0)                 # [Hkv, D, S]
    vv = prec.act(v).permute(1, 0, 2)                 # [Hkv, S, D]
    out = torch.empty((S, Hq, D), dtype=torch.float32, device=q.device)
    kpos = torch.arange(S, device=q.device)
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        qb = prec.act(q[lo:hi]).reshape(hi - lo, Hkv, G, D).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kk[:, None]) * scale     # [Hkv, G, n, S]
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        ok = kpos[None, :] <= qpos
        if window:
            ok &= kpos[None, :] > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(prec.act(p), vv[:, None])    # [Hkv, G, n, D]
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, Hq, D)
    return out


def glu(p, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """SiLU-gated FFN; ``p`` holds ``wi``, ``wg``, ``wo`` as ``[in, out]``."""
    h = silu(prec.mm(x, prec.weight(p["wg"]))) * prec.mm(
        x, prec.weight(p["wi"]))
    return prec.mm(h, prec.weight(p["wo"]))


def head_logits(embed, x: torch.Tensor, eps: float,
                prec: Precision, rows: Optional[slice] = None):
    """Final norm and output head over the positions ``rows`` of x [S, d]."""
    if rows is not None:
        x = x[rows]
    return prec.mm(rmsnorm(x, embed["final_norm"], eps),
                   prec.weight(embed["head"]))
