"""Token sampling for the serving engine."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 0.0, top_k: int = 0,
           rows: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
    """logits: [B, V] -> int32 tokens [B]. Temperature 0 is greedy (ties go
    to the first index). Otherwise the reference's Gumbel-max draw
    (``jax.random.categorical``, its "low" mode), in the logits' dtype:

    * ``logits / temperature`` with the temperature rounded to that dtype,
      as JAX rounds a Python float;
    * uniforms quantised as ``jax.random.uniform`` makes them: ``m *
      2**-nmant`` for a random ``m`` below ``2**nmant`` (nmant, the
      dtype's mantissa bits), raised to the dtype's ``tiny``. In bf16 that
      is 128 values, the largest 127/128, so the noise is at most 4.85;
    * ``-log(-log(u))`` and its sum with the logits, each rounded to the
      dtype; the argmax takes the first index on ties.

    One draw from ``generator`` (on the logits' device) per call, with no
    host round trip. ``rows``, ``(index, total)``: the logits are rows
    ``index`` of a batch of ``total`` rows (a server's data row of its
    slots), whose noise is drawn whole, as one device draws it for the
    whole batch, and these rows' taken."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    dtype = logits.dtype
    z = logits / float(torch.tensor(temperature, dtype=dtype))
    if top_k:
        thresh = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = z.masked_fill(z < thresh, float("-inf"))
    info = torch.finfo(dtype)
    shape = z.shape if rows is None else (rows[1], z.shape[-1])
    m = torch.randint(0, round(1 / info.eps), shape, generator=generator,
                      device=z.device)
    if rows is not None:
        m = m[rows[0]]
    u = (m * info.eps).to(dtype).clamp_min(info.tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(z + gumbel, dim=-1).to(torch.int32)
