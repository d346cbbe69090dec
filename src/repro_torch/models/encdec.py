"""Encoder-decoder transformer (seamless-m4t backbone).

Port of ``repro.models.encdec``. The audio frontend
is a stub, as in the reference: ``batch["frames"]`` carries precomputed
frame embeddings [B, S_enc, d] (fp32 or bf16; cast to the working dtype).
The encoder runs non-causal flash prefill over them; the decoder runs
causal self-attention over its text tokens, then non-causal
cross-attention over the encoder memory, then the GLU FFN.

Parameters keep the reference's tree: ``{"embed", "enc_norm", "enc",
"dec"}``, the encoder and decoder layers each stacked on ``[L]``.

The cache is ``{"k", "v": [L, B, Smax, Hkv, D], "ck", "cv": [L, B, S_enc,
Hkv, D], "lengths": [B]}``: the decoder's self K/V and each layer's K/V of
the memory, computed once in prefill. ``decode_step`` writes the new self
K/V rows into the cache it is given, in place, and attends the memory with
``S_enc = ck.shape[2]`` valid rows, as the reference does: a memory that
admission padded into a longer slot cache (``init_cache(slots, max_len)``
without ``enc_len``) is attended with its zero rows too.

``loss_fn`` is the training forward: the encoder (non-causal
:func:`attention_train`), then the decoder (causal self-attention,
non-causal cross-attention over the memory), each layer under ``remat``,
with the plain RMSNorm, then ``chunked_loss``.

On a mesh (``build(..., mesh=, rules=)``) ``common.Placement`` lays the
leaves out by the reference's logical axes, as ``models.transformer``
does: the encoder's self-attention, the decoder's self- and
cross-attention and both stacks' FFNs split by head and ``d_ff`` over
``model`` (each output projection summed over it by
``common.row_parallel``), the embedding and head by vocab; the cache holds
the rank's kv heads, of the memory's K/V too. Under ``fsdp`` each dense
leaf is stored over ``data`` and gathered a layer at a time."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model, tp_of
from repro_torch.models.common import (
    Placement, Spec, add_rmsnorm, attention_decode, attention_prefill,
    attention_train, attn_qkv, attn_specs, cache_update, chunked_loss,
    embed_specs, embed_tokens, glu_apply, glu_specs, init_tree,
    last_valid_slice, lm_head, rmsnorm, rope, rope_tables, row_parallel,
    stacked, unstack, with_remat,
)


def build(cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype,
          remat: str = "full", mesh=None, rules=None) -> Model:
    pd = cfg.padded(tp_of(mesh))
    nq, nkv, hd, V = pd.num_q_heads, pd.num_kv_heads, pd.head_dim, pd.vocab_size
    d, L, eps = cfg.d_model, cfg.num_layers, cfg.norm_eps

    enc_layer = {
        "ln1": Spec((d,), "ones"),
        "attn": attn_specs(d, nq, nkv, hd, cfg.qkv_bias),
        "ln2": Spec((d,), "ones"),
        "ffn": glu_specs(d, cfg.d_ff),
    }
    dec_layer = {
        "ln1": Spec((d,), "ones"),
        "self": attn_specs(d, nq, nkv, hd, cfg.qkv_bias),
        "ln_x": Spec((d,), "ones"),
        "cross": attn_specs(d, nq, nkv, hd, cfg.qkv_bias),
        "ln2": Spec((d,), "ones"),
        "ffn": glu_specs(d, cfg.d_ff),
    }
    specs = {
        "embed": embed_specs(V, d),
        "enc_norm": Spec((d,), "ones"),
        "enc": stacked(enc_layer, L),
        "dec": stacked(dec_layer, L),
    }
    place = Placement(mesh, rules, specs)
    heads_ax, kv_ax, ffn_ax, vocab_ax = (place.split[k] for k in (
        "heads", "kv_heads", "ffn", "vocab"))
    nq_l = nq // place.size(heads_ax)
    nkv_l = nkv // place.size(kv_ax)

    def init(gen: torch.Generator):
        """Seeded parameters on the model's device (``gen`` lives there):
        on a mesh, this rank's blocks of the one-device draw."""
        return init_tree(gen, specs, device, dtype, place.blocks)

    def _positions(S: int):
        return rope_tables(torch.arange(S, device=device)[None, :], hd,
                           cfg.rope_theta)

    def _out(p, o):
        """An attention output [B, S, heads, D] through ``wo``, summed over
        the ranks that split the heads."""
        B, S = o.shape[:2]
        return row_parallel(o.reshape(B, S, nq_l * hd), p["wo"], heads_ax,
                            mesh=mesh)

    def _stack(params, name: str, gather: bool = True):
        """One stack's layers as each uses them: views of its slice of the
        stack, the dense leaves gathered where the layout says."""
        for lp in unstack(params[name], L):
            yield place.gathered(lp, name, layer=True) if gather else lp

    def enc_block(x, lp, tables, train: bool):
        B, S, _ = x.shape
        if train:               # gathered inside the layer's checkpoint
            lp = place.gathered(lp, "enc", layer=True)
        h = rmsnorm(x, lp["ln1"], eps, train=train)
        q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
        q, k = rope(q, tables), rope(k, tables)
        o = (attention_train(q, k, v, causal=False) if train
             else attention_prefill(q, k, v, causal=False))
        x, h2 = add_rmsnorm(x, _out(lp["attn"], o), lp["ln2"], eps,
                            train=train)
        return x + glu_apply(lp["ffn"], h2, ffn_ax, mesh=mesh)

    enc_block_remat = with_remat(enc_block, remat)

    def _encode(params, frames, train: bool = False):
        x = frames.to(dtype)
        tables = _positions(x.shape[1])
        block = enc_block_remat if train else enc_block
        for lp in _stack(params, "enc", gather=not train):
            x = block(x, lp, tables, train)
        return rmsnorm(x, params["enc_norm"], eps, train=train)

    def _cross_q(p, h):
        B, S, _ = h.shape
        q = h @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        return q.view(B, S, nq_l, hd)

    def _cross_kv(p, memory):
        B, S, _ = memory.shape
        k, v = memory @ p["wk"], memory @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        return k.view(B, S, nkv_l, hd), v.view(B, S, nkv_l, hd)

    # ---------------- train ----------------
    def dec_block_train(x, lp, memory, tables):
        """One decoder layer of the training forward; the layer gathers
        its weights inside its checkpoint."""
        lp = place.gathered(lp, "dec", layer=True)
        h = rmsnorm(x, lp["ln1"], eps, train=True)
        q, k, v = attn_qkv(lp["self"], h, nq_l, nkv_l, hd)
        q, k = rope(q, tables), rope(k, tables)
        o = attention_train(q, k, v, causal=True)
        x, h = add_rmsnorm(x, _out(lp["self"], o), lp["ln_x"], eps,
                           train=True)
        ck, cv = _cross_kv(lp["cross"], memory)
        ox = attention_train(_cross_q(lp["cross"], h), ck, cv, causal=False)
        x, h2 = add_rmsnorm(x, _out(lp["cross"], ox), lp["ln2"], eps,
                            train=True)
        return x + glu_apply(lp["ffn"], h2, ffn_ax, mesh=mesh)

    dec_block = with_remat(dec_block_train, remat)

    def loss_fn(params, batch):
        """batch: ``frames`` [B,S_enc,d], ``tokens``, ``labels`` [B,S] ->
        mean cross-entropy over the decoder positions, fp32."""
        embed = place.gathered(params["embed"], "embed")
        memory = _encode(params, batch["frames"], train=True)
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        tables = _positions(x.shape[1])
        for lp in _stack(params, "dec", gather=False):
            x = dec_block(x, lp, memory, tables)
        return chunked_loss(embed, x, batch["labels"], eps, axes=vocab_ax,
                            mesh=mesh)

    # ---------------- prefill ----------------
    def prefill(params, batch, max_len: Optional[int] = None):
        """batch: ``frames`` [B, S_enc, d], ``tokens`` [B, S] and optional
        per-sample ``lengths`` [B] (right-padded decoder prompts). Returns
        last-token logits [B, V] (this rank's vocab block where
        ``extras["vocab_axes"]`` split it) and the cache, self K/V padded
        to ``max_len`` positions."""
        embed = place.gathered(params["embed"], "embed")
        memory = _encode(params, batch["frames"])
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        B, S, _ = x.shape
        S_enc = memory.shape[1]
        Smax = max_len or S
        vl = batch.get("lengths")
        ks = torch.zeros((L, B, Smax, nkv_l, hd), dtype=x.dtype,
                         device=device)
        vs = torch.zeros_like(ks)
        cks = torch.empty((L, B, S_enc, nkv_l, hd), dtype=x.dtype,
                          device=device)
        cvs = torch.empty_like(cks)
        tables = _positions(S)
        for i, lp in enumerate(_stack(params, "dec")):
            h = rmsnorm(x, lp["ln1"], eps)
            q, k, v = attn_qkv(lp["self"], h, nq_l, nkv_l, hd)
            q, k = rope(q, tables), rope(k, tables)
            o = attention_prefill(q, k, v, causal=True, kv_valid=vl)
            x, h = add_rmsnorm(x, _out(lp["self"], o), lp["ln_x"], eps)
            ck, cv = _cross_kv(lp["cross"], memory)
            ox = attention_prefill(_cross_q(lp["cross"], h), ck, cv,
                                   causal=False)
            x, h2 = add_rmsnorm(x, _out(lp["cross"], ox), lp["ln2"], eps)
            x = x + glu_apply(lp["ffn"], h2, ffn_ax, mesh=mesh)
            ks[i, :, :S], vs[i, :, :S] = k, v
            cks[i], cvs[i] = ck, cv
        x_last = (x[:, -1:].contiguous() if vl is None
                  else last_valid_slice(x, vl))
        logits = lm_head(embed, x_last, eps)[:, 0]
        lengths = (torch.full((B,), S, dtype=torch.int32, device=device)
                   if vl is None else vl.to(torch.int32))
        return logits, {"k": ks, "v": vs, "ck": cks, "cv": cvs,
                        "lengths": lengths}

    # ---------------- decode ----------------
    def decode_step(params, cache, tokens, lengths):
        """tokens: [B,1]; lengths: [B] int32 current decoder length per
        sample. Writes the new self K/V rows into ``cache`` in place."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, tokens, vocab_ax, mesh=mesh)
        B = x.shape[0]
        tables = rope_tables(lengths[:, None], hd, cfg.rope_theta)
        valid = lengths + 1
        # every memory row counts, padding included (the reference's
        # ``enc_len = ck.shape[1]``)
        enc_len = torch.full((B,), cache["ck"].shape[2], dtype=torch.int32,
                             device=device)
        k_layers = torch.unbind(cache["k"], 0)
        v_layers = torch.unbind(cache["v"], 0)
        ck_layers = torch.unbind(cache["ck"], 0)
        cv_layers = torch.unbind(cache["cv"], 0)
        for i, lp in enumerate(_stack(params, "dec")):
            h = rmsnorm(x, lp["ln1"], eps)
            q, k, v = attn_qkv(lp["self"], h, nq_l, nkv_l, hd)
            q, k = rope(q, tables), rope(k, tables)
            cache_update(k_layers[i], v_layers[i], k, v, lengths)
            o = attention_decode(q, k_layers[i], v_layers[i], valid)
            x, h = add_rmsnorm(x, _out(lp["self"], o), lp["ln_x"], eps)
            ox = attention_decode(_cross_q(lp["cross"], h), ck_layers[i],
                                  cv_layers[i], enc_len)
            x, h2 = add_rmsnorm(x, _out(lp["cross"], ox), lp["ln2"], eps)
            x = x + glu_apply(lp["ffn"], h2, ffn_ax, mesh=mesh)
        logits = lm_head(embed, x, eps)[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "ck": cache["ck"],
                        "cv": cache["cv"], "lengths": valid}

    def init_cache(batch: int, max_len: int, enc_len: int = 0):
        """Every slot's cache, of this rank's kv heads."""
        kv = (L, batch, max_len, nkv_l, hd)
        ckv = (L, batch, enc_len or max_len, nkv_l, hd)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "ck": torch.zeros(ckv, dtype=dtype, device=device),
                "cv": torch.zeros(ckv, dtype=dtype, device=device),
                "lengths": torch.zeros((batch,), dtype=torch.int32,
                                       device=device)}

    return Model(
        cfg=cfg, device=device, dtype=dtype, init=init, prefill=prefill,
        decode_step=decode_step, init_cache=init_cache, loss_fn=loss_fn,
        extras={"prompt_pad": True, **place.extras()},
    )
