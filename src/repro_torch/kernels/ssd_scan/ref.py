"""Plain PyTorch chunked linear-attention scan (the kernel's reference and
its CPU path).

Port of ``repro.models.linear_core.chunked_linear_attention`` in the model
layout ``[B, S, H, *]``, with ``initial_state`` and ``chunk``. It follows
that jnp function's order of operations, not the Pallas kernel's: scores
from the input-dtype q and k summed in fp32, the carried state read as
``(q . S) * exp(cum)``, and one rounding of y to the input dtype at the
end."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def check_chunk(S: int, chunk: int) -> int:
    """The chunk width ``min(chunk, S)``; raises unless it divides ``S``
    (both references assert it)."""
    W = min(chunk, S)
    if W <= 0 or S % W:
        raise ValueError(f"ssd_scan: sequence length {S} is not a multiple "
                         f"of the chunk {W} (min(chunk={chunk}, S))")
    return W


def ssd_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_f: torch.Tensor, log_i: torch.Tensor, *,
                 chunk: int = 256,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; log_f, log_i: [B, S, H]
    (log_f <= 0); initial_state: [B, H, dk, dv] or None (zeros).

    Returns (y [B, S, H, dv] in v's dtype, final state [B, H, dk, dv]
    fp32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    W = check_chunk(S, chunk)
    nc = S // W
    qc = q.reshape(B, nc, W, H, dk)
    kc = k.reshape(B, nc, W, H, dk)
    vc = v.reshape(B, nc, W, H, dv)
    fc = log_f.reshape(B, nc, W, H).float()
    ic = log_i.reshape(B, nc, W, H).float()
    state = (torch.zeros((B, H, dk, dv), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.float())
    causal = torch.ones((W, W), dtype=torch.bool, device=q.device).tril()
    ys = []
    for c in range(nc):
        qb, kb = qc[:, c].float(), kc[:, c].float()
        vb, fb, ib = vc[:, c].float(), fc[:, c], ic[:, c]
        cum = torch.cumsum(fb, dim=1)                 # inclusive, [B, W, H]
        # inter-chunk: y_state_t = exp(cum_t) * q_t . S
        y_state = (torch.einsum("bwhk,bhkv->bwhv", qb, state)
                   * torch.exp(cum)[..., None])
        # intra-chunk decay-masked scores (q, k products exact in fp32)
        scores = torch.einsum("bwhk,buhk->bhwu", qb, kb)
        decay = cum[:, :, None, :] - cum[:, None, :, :] + ib[:, None, :, :]
        decay = torch.where(causal[None, :, :, None], decay,
                            torch.full_like(decay, float("-inf")))
        scores = scores * torch.exp(decay).permute(0, 3, 1, 2)
        y_intra = torch.einsum("bhwu,buhv->bwhv", scores, vb)
        # state update
        tot = cum[:, -1:, :]                          # [B, 1, H]
        k_scaled = kb * torch.exp(tot - cum + ib)[..., None]
        state = (state * torch.exp(tot[:, 0])[..., None, None]
                 + torch.einsum("bwhk,bwhv->bhkv", k_scaled, vb))
        ys.append((y_state + y_intra).to(v.dtype))
    y = torch.stack(ys, dim=1).reshape(B, S, H, dv)
    return y, state
