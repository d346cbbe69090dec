"""Plain float32 forward pass of a decoder-only mixture-of-experts model
(dbrx, hf:databricks/dbrx-base), the benchmark's reference for the moe
family.

A layer: RMSNorm, grouped-query attention with rotary positions (causal),
the residual add, RMSNorm, and the expert FFN: a float32 router gives each
token a softmax over the experts, its ``top_k`` largest (ties to the lower
expert index) are renormalised to sum to one, and the token's output is
their weighted sum of SiLU-gated FFNs. No token is dropped: the
configuration states dropless routing, as upstream DBRX has it.

The weights are the tree the benchmark makes (``bench/weights.py``):
``embed`` and ``layers``, every layer leaf stacked on a leading axis, the
experts ``[L, E, ...]``. Float32 weights of the whole model would not fit
the card, so :func:`logits_of` runs all the sequences it is given layer by
layer, converting one layer's weights at a time."""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference.common import (
    Precision, attention, head_logits, rmsnorm, rope, silu,
)


def _experts(p: Dict, h: torch.Tensor, top_k: int,
             prec: Precision) -> torch.Tensor:
    """Dropless top-k expert FFN of tokens h [T, d] with one layer's
    float32 (or control-rounded) expert weights ``p``."""
    logits = h.float() @ p["router"]                   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(p["wi"].shape[0]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if not tok.numel():
            continue
        x = h[tok]
        out = prec.mm(silu(prec.mm(x, p["wg"][e])) * prec.mm(x, p["wi"][e]),
                      p["wo"][e])
        y.index_add_(0, tok, out * top_p[tok, slot][:, None])
    return y


def logits_of(params, cfg: Dict, seqs: List[torch.Tensor], firsts: List[int],
              prec: Precision = Precision("fp32")) -> List[torch.Tensor]:
    """Logits [S - first, V] (float32) of each sequence from its ``first``
    position on, the model run layer by layer over all the sequences."""
    eps = cfg["norm_eps"]
    nq, nkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["d_model"] // nq
    emb = params["embed"]["embedding"]
    xs = [emb[s.long()].float() for s in seqs]
    lays = params["layers"]
    for i in range(cfg["num_layers"]):
        a = {k: prec.weight(v[i]) for k, v in lays["attn"].items()}
        m = lays["moe"]
        ex = {"router": m["router"][i].float()}
        for k in ("wi", "wg", "wo"):
            w = m[k][i]
            ex[k] = torch.empty(w.shape, dtype=torch.float32,
                                device=w.device)
            for e in range(w.shape[0]):     # one matrix's temporaries
                ex[k][e] = prec.weight(w[e])
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=x.device)
            h = rmsnorm(x, lays["ln1"][i], eps)
            q = prec.mm(h, a["wq"]).reshape(S, nq, hd)
            k = prec.mm(h, a["wk"]).reshape(S, nkv, hd)
            v = prec.mm(h, a["wv"]).reshape(S, nkv, hd)
            q = rope(q, pos, cfg["rope_theta"])
            k = rope(k, pos, cfg["rope_theta"])
            o = attention(q, k, v, prec=prec)
            x = x + prec.mm(o.reshape(S, nq * hd), a["wo"])
            xs[j] = x + _experts(ex, rmsnorm(x, lays["ln2"][i], eps),
                                 cfg["num_experts_per_tok"], prec)
        del a, ex
    return [head_logits(params["embed"], x, eps, prec, slice(f, x.shape[0]))
            for x, f in zip(xs, firsts)]
