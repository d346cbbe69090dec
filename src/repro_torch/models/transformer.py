"""Decoder-only transformer: the dense, moe and vlm families.

Port of ``repro.models.transformer``. Parameters keep
the reference's tree: ``{"embed": {...}, "layers": {...}}`` with every layer
leaf stacked on a leading ``[L]`` axis. The reference scans over that axis;
here a Python loop walks the layers (``torch.unbind`` gives the per-layer
views without copies). Per-layer sliding windows are static ints.

A moe layer holds ``"moe"`` (fp32 router, experts stacked ``[E, ...]``;
``repro_torch.models.moe``) where a dense one holds ``"ffn"``. The vlm
frontend is a stub, as in the reference: ``batch["prefix_embeddings"]``
[B, P, d] (precomputed patch embeddings) is cast to the working dtype and
put ahead of the text embeddings in ``prefill``; ``lengths`` then still
count text tokens while ``kv_valid`` indexes the prefixed sequence, as in
the reference.

``loss_fn`` is the training forward: every layer (under ``remat``) with
:func:`attention_train` and the plain RMSNorm, then ``chunked_loss`` over
the text positions (a vlm prefix is excluded), plus ``0.01 *`` the moe
layers' summed load-balancing term.

The KV cache is ``{"k", "v": [L, B, Smax, Hkv, D], "lengths": [B]}``.
``decode_step`` writes the new K/V rows into the cache it is given, in
place (the counterpart of the reference's donated cache), and returns it.

On a mesh (``build(..., mesh=, rules=)``; ``launch.mesh`` over a
``torch.distributed`` world) each rank builds the model the reference
builds on that mesh: heads and vocab padded by ``cfg.padded(tp)``, so the
reference's params carry across unchanged, and every entry point takes
this rank's rows of a batch split over the ``batch`` rule's axes.
``common.Placement`` lays the leaves out by the reference's logical axes:
the dense layers tensor parallel over ``model`` (heads, kv heads, ``d_ff``
and vocab split, the attention output and the FFN's down projection
summed over ``model`` by ``common.row_parallel``), under ``fsdp`` their
``d_model`` dim stored over ``data`` and gathered a layer at a time; the
moe layers run expert parallel (``moe.moe_apply`` with the mesh and the
rules' axes). Each rank's params hold its blocks (``extras[
"param_specs"]``; ``bridge.params_for_rank``). With ``rules["seq"] ==
"model"`` prefill is context parallel (ref ``_cp_attention``): each rank
embeds and runs its ``S/tp`` slice of the sequence, attention gathers K/V
over ``model`` and calls ``attention_prefill`` at ``q_offset = rank *
S/tp``, and the cache and logits equal the one-device ones'."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import moe as moe_lib
from repro_torch.models.api import Model
from repro_torch.models.common import (
    Placement, Spec, add_rmsnorm, attention_decode, attention_prefill,
    attention_train, attn_qkv, attn_specs, cache_update, chunked_loss,
    embed_specs, embed_tokens, glu_apply, glu_specs, init_tree,
    last_valid_slice, lm_head, rmsnorm, rope, rope_tables, row_parallel,
    stacked, unstack, with_remat,
)


def _layer_specs(cfg: ModelConfig, nq: int, nkv: int,
                 hd: int) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "ln1": Spec((cfg.d_model,), "ones"),
        "attn": attn_specs(cfg.d_model, nq, nkv, hd, cfg.qkv_bias),
        "ln2": Spec((cfg.d_model,), "ones"),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_lib.moe_specs(cfg.d_model, cfg.d_ff,
                                         cfg.num_experts)
    else:
        specs["ffn"] = glu_specs(cfg.d_model, cfg.d_ff)
    return specs


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer window sizes (0 = full attention)."""
    w = [cfg.window] * cfg.num_layers
    for i in cfg.global_layers:
        w[i] = 0
    return w


def build(cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype,
          remat: str = "full", q_block: int = 512, k_block: int = 1024,
          mesh=None, rules=None) -> Model:
    pd = cfg.padded(mesh.shape.get("model", 1) if mesh is not None else 1)
    nq, nkv, hd, V = pd.num_q_heads, pd.num_kv_heads, pd.head_dim, pd.vocab_size
    d, L = cfg.d_model, cfg.num_layers
    eps = cfg.norm_eps
    specs = {
        "embed": embed_specs(V, d),
        "layers": stacked(_layer_specs(cfg, nq, nkv, hd), L),
    }
    windows = _layer_windows(cfg)
    moe_dims = None
    if cfg.family == "moe":
        moe_dims = moe_lib.MoEDims(cfg.num_experts, cfg.num_experts_per_tok,
                                   cfg.moe_capacity_factor, d, cfg.d_ff)
    place = Placement(mesh, rules, specs)
    cp = place.cp
    # this rank's heads, and the mesh axes the dense leaves stay split over
    # once each layer has gathered what it gathers
    heads_ax, kv_ax, ffn_ax, vocab_ax = (place.split[k] for k in (
        "heads", "kv_heads", "ffn", "vocab"))
    nq_l = nq // place.size(heads_ax)
    nkv_l = nkv // place.size(kv_ax)

    def init(gen: torch.Generator):
        """Seeded parameters on the model's device (``gen`` lives there):
        on a mesh, this rank's blocks of the one-device draw
        (``common.init_tree``)."""
        return init_tree(gen, specs, device, dtype, place.blocks)

    def _ffn(lp, h, need_aux: bool = False):
        """(FFN output, moe load-balancing term or 0)."""
        if moe_dims is None:
            return glu_apply(lp["ffn"], h, ffn_ax, mesh=mesh), 0.0
        if mesh is None:
            return moe_lib.moe_apply(lp["moe"], h, moe_dims)
        if cp:          # the experts serve the whole sequence's tokens
            y, aux = _ffn(lp, sh.all_gather(h, "model", 1, mesh=mesh),
                          need_aux)
            n = h.shape[1]
            r = sh.axis_index("model", mesh=mesh)
            return y[:, r * n:(r + 1) * n], aux
        return moe_lib.moe_apply(
            lp["moe"], h, moe_dims, mesh=mesh, batch_axes=place.batch_axes,
            fsdp_axis=_axis(place.rules, "fsdp"),
            ffn2d_axis=_axis(place.rules, "expert_ffn"), need_aux=need_aux)

    def _attn_out_ffn(x, o, lp):
        """Residual add of the attention output, second norm, FFN."""
        x, h2 = add_rmsnorm(x, row_parallel(o, lp["attn"]["wo"], heads_ax,
                                            mesh=mesh), lp["ln2"], eps)
        return x + _ffn(lp, h2)[0]

    def _embed_input(embed, batch):
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        if cfg.frontend == "vision" and "prefix_embeddings" in batch:
            pre = batch["prefix_embeddings"].to(x.dtype)
            x = torch.cat([pre, x], dim=1)
        return x

    def _layers(params):
        """Each layer's leaves as it uses them: the views of its slice of
        the stack, the dense ones gathered where the layout says
        (``Placement.gathered``)."""
        for lp in unstack(params["layers"], L):
            yield place.gathered(lp, "layers", layer=True)

    # ---------------- train ----------------
    def layer_train(x, lp, tables, window: int):
        """One layer of the training forward -> (x, moe aux term)."""
        B, S, _ = x.shape
        lp = place.gathered(lp, "layers", layer=True)
        h = rmsnorm(x, lp["ln1"], eps, train=True)
        q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
        q, k = rope(q, tables), rope(k, tables)
        o = attention_train(q, k, v, causal=True, window=window)
        x, h2 = add_rmsnorm(x, row_parallel(o.reshape(B, S, nq_l * hd),
                                            lp["attn"]["wo"], heads_ax,
                                            mesh=mesh),
                            lp["ln2"], eps, train=True)
        y, aux = _ffn(lp, h2, need_aux=True)
        return x + y, aux

    layer = with_remat(layer_train, remat)

    def _backbone_train(params, x):
        tables = rope_tables(torch.arange(x.shape[1], device=x.device)[None],
                             hd, cfg.rope_theta)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # the gathers run inside each layer's checkpoint, so the backward
        # pass gathers again where it recomputes the layer
        for i, lp in enumerate(unstack(params["layers"], L)):
            x, a = layer(x, lp, tables, windows[i])
            aux = aux + a
        return x, aux

    def loss_fn(params, batch):
        """batch: ``tokens``, ``labels`` [B,S] (vlm: optional
        ``prefix_embeddings`` [B,P,d] ahead of the tokens) -> the mean
        cross-entropy over the text positions (+ 0.01 * moe aux), fp32."""
        embed = place.gathered(params["embed"], "embed")
        x, aux = _backbone_train(params, _embed_input(embed, batch))
        n_text = batch["tokens"].shape[1]
        ce = chunked_loss(embed, x[:, -n_text:], batch["labels"], eps,
                          axes=vocab_ax, mesh=mesh)
        return ce + 0.01 * aux

    # ---------------- prefill ----------------
    def prefill(params, batch, max_len: Optional[int] = None):
        """batch: ``tokens`` [B,S] and optional per-sample ``lengths`` [B]
        (right-padded prompts); vlm: optional ``prefix_embeddings`` [B,P,d]
        ahead of the tokens. Returns last-token logits [B,V] (this rank's
        vocab block where ``extras["vocab_axes"]`` split it) and a cache
        padded to ``max_len`` positions; rows past a prompt's length hold
        the padding's K/V, as in the reference."""
        embed = place.gathered(params["embed"], "embed")
        x = _embed_input(embed, batch)
        B, S, _ = x.shape
        Smax = max_len or S
        vl = batch.get("lengths")
        ks = torch.zeros((L, B, Smax, nkv_l, hd), dtype=x.dtype,
                         device=device)
        vs = torch.zeros_like(ks)
        lo, n = 0, S                     # this rank's rows of the sequence
        if cp:
            tp = mesh.shape["model"]
            if S % tp:
                raise ValueError(f"context-parallel prefill: S={S} does not "
                                 f"split over model = {tp}")
            n = S // tp
            lo = sh.axis_index("model", mesh=mesh) * n
            x = x[:, lo:lo + n].contiguous()
        tables = rope_tables(torch.arange(lo, lo + n, device=device)[None, :],
                             hd, cfg.rope_theta)
        for i, lp in enumerate(_layers(params)):
            h = rmsnorm(x, lp["ln1"], eps)
            q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
            q, k = rope(q, tables), rope(k, tables)
            if cp:      # K/V gathered once per layer (ref _cp_attention)
                k = sh.all_gather(k, "model", 1, mesh=mesh)
                v = sh.all_gather(v, "model", 1, mesh=mesh)
            o = attention_prefill(q, k, v, causal=True, window=windows[i],
                                  q_block=min(q_block, n) if cp else q_block,
                                  k_block=k_block, q_offset=lo, kv_valid=vl)
            x = _attn_out_ffn(x, o.reshape(B, n, nq_l * hd), lp)
            ks[i, :, :S] = k
            vs[i, :, :S] = v
        if cp:
            x = sh.all_gather(x, "model", 1, mesh=mesh)
        x_last = (x[:, -1:].contiguous() if vl is None
                  else last_valid_slice(x, vl))
        logits = lm_head(embed, x_last, eps)[:, 0]
        lengths = (torch.full((B,), S, dtype=torch.int32, device=device)
                   if vl is None else vl.to(torch.int32))
        return logits, {"k": ks, "v": vs, "lengths": lengths}

    # ---------------- decode ----------------
    def decode_step(params, cache, tokens, lengths):
        """tokens: [B,1]; lengths: [B] int32 current context length per
        sample. Writes the new K/V rows into ``cache`` in place."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, tokens, vocab_ax, mesh=mesh)
        B = x.shape[0]
        tables = rope_tables(lengths[:, None], hd, cfg.rope_theta)
        valid = lengths + 1
        k_layers = torch.unbind(cache["k"], 0)
        v_layers = torch.unbind(cache["v"], 0)
        for i, lp in enumerate(_layers(params)):
            h = rmsnorm(x, lp["ln1"], eps)
            q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
            q, k = rope(q, tables), rope(k, tables)
            cache_update(k_layers[i], v_layers[i], k, v, lengths)
            o = attention_decode(q, k_layers[i], v_layers[i], valid,
                                 window=windows[i])
            x = _attn_out_ffn(x, o.reshape(B, 1, nq_l * hd), lp)
        logits = lm_head(embed, x, eps)[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "lengths": valid}

    def init_cache(batch: int, max_len: int):
        """This rank's kv heads of every slot's cache."""
        shape = (L, batch, max_len, nkv_l, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "lengths": torch.zeros((batch,), dtype=torch.int32,
                                       device=device)}

    return Model(
        cfg=cfg, device=device, dtype=dtype, init=init, prefill=prefill,
        decode_step=decode_step, init_cache=init_cache, loss_fn=loss_fn,
        # moe excluded from prompt padding, as in the reference: junk
        # tokens contend for expert capacity
        extras={"prompt_pad": cfg.family != "moe", **place.extras()},
    )


def _axis(rules, name):
    """The rule's first mesh axis (the reference's ``_axis``)."""
    v = rules.get(name)
    if isinstance(v, tuple):
        v = v[0] if v else None
    return v
