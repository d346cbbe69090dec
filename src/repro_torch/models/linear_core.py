"""Chunked linear-attention core of the mLSTM (xlstm) blocks.

Port of ``repro.models.linear_core``. A matrix-memory recurrence with
per-step scalar gates,

    S_t = f_t * S_{t-1} + i_t * k_t v_t^T          (S: [dk, dv] per head)
    y_t = q_t . S_t

runs over a whole prompt in chunkwise-parallel form
(:func:`chunked_linear_attention`, routed to the ``ssd_scan`` kernel, or
to its plain version in the training forward) and
one token at a time in decode (:func:`linear_attention_step`, which updates
the state it is given in place)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def chunked_linear_attention(q, k, v, log_f, log_i, *, chunk: int = 256,
                             initial_state: Optional[torch.Tensor] = None,
                             train: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B,S,H,dk]; v: [B,S,H,dv]; log_f, log_i: [B,S,H] (log_f <= 0);
    initial_state: [B,H,dk,dv] fp32 or None. ``train``: the plain
    (differentiable) scan in place of the kernel's wrapper.

    Returns (y [B,S,H,dv], final_state [B,H,dk,dv] fp32)."""
    return (ssd_scan_ref if train else ssd_scan_op)(
        q, k, v, log_f, log_i, chunk=chunk, initial_state=initial_state)


def pad_mask_gates(log_f, log_i, vl):
    """Neutralize gates at right-pad junk positions (pos >= vl[b]): forget
    gate 1 (log 0) and input gate 0 (log -1e30, not -inf), so the state after
    a padded sequence equals the state after the unpadded prompt exactly.
    log_f/log_i: [B,S,H]; vl: [B] valid lengths."""
    pos = torch.arange(log_f.shape[1], device=log_f.device)
    ok = pos[None, :, None] < vl[:, None, None]
    return (torch.where(ok, log_f, torch.zeros_like(log_f)),
            torch.where(ok, log_i, torch.full_like(log_i, -1e30)))


def linear_attention_step(state, q, k, v, log_f, log_i):
    """One decode step, updating ``state`` in place. state [B,H,dk,dv] fp32;
    q, k [B,H,dk]; v [B,H,dv]; log_f/log_i [B,H]. Returns (y [B,H,dv],
    state). The reference's ``f * state + i * outer`` compiles to one
    fused multiply-add, ``fma(f, state, round(i * outer))``; ``addcmul``
    rounds the same way."""
    f = torch.exp(log_f.float())[..., None, None]
    i = torch.exp(log_i.float())[..., None, None]
    outer = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    state.copy_(outer.mul_(i).addcmul_(state, f))
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return y.to(v.dtype), state


def normalized_readout(y_aug):
    """mLSTM normalizer trick: v was augmented with a ones column; divide the
    first dv outputs by max(|last column|, 1)."""
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    return y / n.abs().clamp_min(1.0).to(y.dtype)
