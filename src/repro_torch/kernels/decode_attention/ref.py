"""Plain PyTorch decode attention (the kernel's reference and its CPU path).

Follows ``repro.models.common.attention_decode`` step for step, rounding
where it rounds: ``q * scale`` in the input dtype, fp32 scores and softmax,
``p`` cast to the cache dtype before the PV product."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import softmax_scale

NO_WINDOW = 1 << 30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, 1, Hq, D]; k/v_cache: [B, Smax, Hkv, D]; lengths: [B] valid
    positions -> [B, 1, Hq, D]. Rows with ``lengths == 0`` are 0."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    w = window if window > 0 else NO_WINDOW
    qg = (q.reshape(B, Hkv, G, D)
          * softmax_scale(scale, D, q.dtype)).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    k_pos = torch.arange(Smax, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = (k_pos < lens) & (k_pos >= lens - w)                 # [B, Smax]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None, None], p,
                    torch.zeros_like(p))
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.to(v_cache.dtype).reshape(B, 1, Hq, D)
