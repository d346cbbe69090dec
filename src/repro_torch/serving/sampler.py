"""Token sampling for the serving engine."""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: [B, V] -> int32 tokens [B]. Temperature 0 is greedy (ties go
    to the first index). Otherwise a Gumbel-max draw from
    ``softmax(logits / temperature)`` with uniforms from ``generator`` (on
    the logits' device), computed in fp32 on the device with no host
    round trip."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    z = logits.float() / temperature
    if top_k:
        thresh = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = z.masked_fill(z < thresh, float("-inf"))
    u = torch.rand(z.shape, generator=generator, device=z.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(z + gumbel, dim=-1).to(torch.int32)
