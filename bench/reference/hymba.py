"""Plain float32 forward pass of hymba (arXiv:2411.13676), the benchmark's
reference for the hybrid family.

Each block feeds one normed input to two branches side by side and averages
their normed outputs into the residual, then a SiLU-gated FFN follows:

* grouped-query attention with rotary positions, causal, within the last
  ``window`` positions except on the global layers;
* an SSD (Mamba-2 style) branch: an input projection to x and a gate z, a
  depthwise causal convolution of width ``conv_width`` and SiLU on x, the
  B and C projections (``ssm_state`` wide a head), a step size
  ``dt = clip(softplus(h W_dt + b_dt), 1e-4, 8)`` a head, the decay
  ``a = -dt exp(a_log)``, and the matrix-state recurrence

      S_t = exp(a_t) S_{t-1} + dt_t B_t x_t^T,   y_t = C_t . S_t

  written here in its quadratic form over the whole sequence,
  ``y_t = sum_{s <= t} exp(A_t - A_s) dt_s (C_t . B_s) x_s`` with ``A`` the
  cumulative sum of ``a``; then ``y + d_skip x``, times ``silu(z)``, and the
  output projection.

The weights are the tree the benchmark makes (``bench/weights.py``), the
one the program is handed too: ``embed`` (``embedding``, ``head``,
``final_norm``), the global layers stacked in ``g`` and the others in
``swa``, in that order of execution: global layer i, then the
sliding-window layers up to the next global one. The forward runs one
sequence at a time over all its positions, so it keeps no cache: the ring
of the windowed layers and the carried SSD state are what this recomputes
from the whole sequence."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench.reference.common import (
    Precision, attention, glu, head_logits, rmsnorm, rope, silu,
)


def layer_order(num_layers: int, global_layers: Sequence[int]):
    """(stack, index in it, window applies) of each layer in order."""
    gl = set(global_layers)
    g = w = 0
    for i in range(num_layers):
        if i in gl:
            yield "g", g, False
            g += 1
        else:
            yield "swa", w, True
            w += 1


def _layer(lp, i: int) -> Dict:
    """Layer ``i`` of a stacked subtree."""
    if isinstance(lp, dict):
        return {k: _layer(v, i) for k, v in lp.items()}
    return lp[i]


def _ssd(p, h: torch.Tensor, cfg, prec: Precision) -> torch.Tensor:
    """The SSD branch over one sequence h [S, d] from zero state."""
    S = h.shape[0]
    H = p["w_dt"].shape[1]
    ds = cfg["ssm_state"]
    d_inner = p["w_out"].shape[0]
    hd = d_inner // H
    up = prec.mm(h, prec.weight(p["w_in"]))
    x, z = up[:, :d_inner], up[:, d_inner:]
    kern = p["conv"].float()                          # [W, d_inner]
    Wc = kern.shape[0]
    xp = torch.cat([x.new_zeros((Wc - 1, d_inner)), x], 0)
    x = silu(sum(xp[j:j + S] * kern[j] for j in range(Wc)))
    bc = prec.mm(h, prec.weight(p["w_bc"]))
    b = bc[:, :H * ds].reshape(S, H, ds)
    c = bc[:, H * ds:].reshape(S, H, ds)
    dt = torch.nn.functional.softplus(
        h.float() @ p["w_dt"].float() + p["b_dt"].float()).clamp(1e-4, 8.0)
    a = -dt * torch.exp(p["a_log"].float())           # [S, H]
    A = torch.cumsum(a, 0)
    v = x.reshape(S, H, hd)
    t = torch.arange(S, device=h.device)
    causal = t[None, :] <= t[:, None]                 # [t, s]
    y = torch.empty_like(v)
    for hh in range(H):
        # decay from s to t, times dt_s, zero above the diagonal
        L = (A[:, hh, None] - A[None, :, hh]).masked_fill(~causal,
                                                          float("-inf"))
        L = torch.exp(L) * dt[None, :, hh]
        scores = prec.act(c[:, hh]) @ prec.act(b[:, hh]).T   # [t, s]
        y[:, hh] = prec.mm(scores * L, prec.act(v[:, hh]))
    y = y + v * p["d_skip"].float()[:, None]
    return prec.mm((y.reshape(S, d_inner) * silu(z)),
                   prec.weight(p["w_out"]))


def forward(params, cfg: Dict, tokens: torch.Tensor, *,
            prec: Precision = Precision("fp32"),
            first: int = 0) -> torch.Tensor:
    """Logits [S - first, V] (float32) at positions ``first`` .. S-1 of one
    sequence ``tokens`` [S]."""
    eps = cfg["norm_eps"]
    nq, nkv = cfg["num_heads"], cfg["num_kv_heads"]
    d = cfg["d_model"]
    hd = d // nq
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"]["embedding"][tokens.long()].float()
    for stack, i, windowed in layer_order(cfg["num_layers"],
                                          cfg["global_layers"]):
        lp = _layer(params[stack], i)
        h = rmsnorm(x, lp["ln"], eps)
        a = lp["attn"]
        q = prec.mm(h, prec.weight(a["wq"])).reshape(S, nq, hd)
        k = prec.mm(h, prec.weight(a["wk"])).reshape(S, nkv, hd)
        v = prec.mm(h, prec.weight(a["wv"])).reshape(S, nkv, hd)
        q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
        o = attention(q, k, v, window=cfg["window"] if windowed else 0,
                      prec=prec)
        a_out = prec.mm(o.reshape(S, nq * hd), prec.weight(a["wo"]))
        s_out = _ssd(lp["ssd"], h, cfg, prec)
        x = x + 0.5 * (rmsnorm(a_out, lp["ln_attn"], eps)
                       + rmsnorm(s_out, lp["ln_ssd"], eps))
        x = x + glu(lp["ffn"], rmsnorm(x, lp["ln2"], eps), prec)
    return head_logits(params["embed"], x, eps, prec, slice(first, S))


def logits_of(params, cfg: Dict, seqs: List[torch.Tensor], firsts: List[int],
              prec: Precision = Precision("fp32")) -> List[torch.Tensor]:
    """:func:`forward` of each sequence from its ``first`` position."""
    return [forward(params, cfg, s, prec=prec, first=f)
            for s, f in zip(seqs, firsts)]
