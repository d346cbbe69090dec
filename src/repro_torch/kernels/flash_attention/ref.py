"""Plain PyTorch prefill attention (the kernel's reference and its CPU path).

Follows ``repro.models.common.attention_prefill`` block for block: q and k
blocks of ``q_block`` / ``k_block`` rows, online softmax across the visited k
blocks, causal / window block skipping, the -1e30 mask floor and
``max(l, 1e-30)``, rounding where it rounds (``q * scale`` in the input dtype,
fp32 scores, ``p`` and each block's PV product in the value dtype)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import softmax_scale

NO_WINDOW = 1 << 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_block: int = 512, k_block: int = 1024,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None,
                        kv_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; kv_valid: [B] or None ->
    [B, Sq, Hq, D]."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_block = min(q_block, Sq)
    k_block = min(k_block, Sk)
    if Sq % q_block or Sk % k_block:
        raise ValueError(f"blocks must divide the lengths: Sq={Sq} "
                         f"q_block={q_block} Sk={Sk} k_block={k_block}")
    w = window if window > 0 else NO_WINDOW
    if q_offset is None:
        q_offset = Sk - Sq
    dev = q.device
    qg = (q.reshape(B, Sq, Hkv, G, D)
          * softmax_scale(scale, D, q.dtype)).float()
    kf, vf = k.float(), v.float()
    nk = Sk // k_block
    blocks = []
    for qi in range(Sq // q_block):
        qb = qg[:, qi * q_block:(qi + 1) * q_block]
        q_lo = qi * q_block + q_offset
        q_hi = q_lo + q_block - 1
        k_end = min(q_hi // k_block + 1, nk) if causal else nk
        k_start = max(0, (q_lo - w + 1) // k_block)
        acc = torch.zeros((B, q_block, Hkv, G, D), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, Hkv, G, q_block), -math.inf, device=dev)
        l = torch.zeros((B, Hkv, G, q_block), device=dev)
        q_pos = q_lo + torch.arange(q_block, device=dev)[:, None]
        for ki in range(k_start, k_end):
            kb = kf[:, ki * k_block:(ki + 1) * k_block]
            vb = v[:, ki * k_block:(ki + 1) * k_block]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
            k_pos = ki * k_block + torch.arange(k_block, device=dev)[None, :]
            mask = k_pos > q_pos - w
            if causal:
                mask = mask & (k_pos <= q_pos)
            full = mask[None, None, None]
            if kv_valid is not None:
                vm = k_pos[0] < kv_valid.long()[:, None]          # [B, kb]
                full = full & vm[:, None, None, None, :]
            s = torch.where(full, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None]
            pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(),
                              vb.float())
            acc = acc + pv.to(v.dtype).float()
            m = m_new
        safe_l = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        blocks.append((acc / safe_l).to(q.dtype))
    return torch.cat(blocks, dim=1).reshape(B, Sq, Hq, D)
