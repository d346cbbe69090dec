"""Hymba, hybrid family: blocks with *parallel* attention and SSD heads.

Port of ``repro.models.hymba``. Each block feeds the
same normed input to (a) GQA attention, sliding-window except on the
global layers, and (b) an SSD branch (mamba2-style: in-projection, a short
causal conv, the scalar-decay matrix-state recurrence of the chunked linear
core, a silu gate, out-projection). The two outputs are RMS-normed each and
averaged, then a GLU FFN follows.

Parameters keep the reference's tree: ``{"embed": {...}, "g": {...},
"swa": {...}}``, the global-attention layers stacked on ``[n_global]`` and
the sliding-window layers on ``[n_swa]``; ``w_dt``, ``b_dt``, ``a_log`` and
``d_skip`` are fp32. Layers run in the reference's order: global layer
``i``, then the ``_segments(cfg)[i]`` sliding-window layers that follow it
(the reference unrolls the global layers and scans each segment; here a
Python loop walks both).

``loss_fn`` runs every layer in that order from zero conv and SSD states
with :func:`attention_train` (the window on the sliding-window layers),
the plain RMSNorm and the plain chunked scan, each layer under ``remat``,
then ``chunked_loss``.

The cache has the reference's leaves, each stacked by layer ``[L, B, ...]``:
``kg``/``vg`` [n_global, B, Smax, Hkv, D] (full-length), ``kw``/``vw``
[n_swa, B, W, Hkv, D] (window-sized ring buffers: position p at slot
p % W), ``conv_g``/``conv_w`` [., B, conv_width - 1, d_inner] (the conv's
trailing inputs), ``ssd_g``/``ssd_w`` [., B, H, ssm_state, D] fp32, and
``lengths`` [B]. ``decode_step`` updates every leaf of the cache it is
given in place (the counterpart of the reference's donated cache): K/V
rows, ring rows, conv and SSD states.

On a mesh (``build(..., mesh=, rules=)``) the block runs head parallel
over ``model``, laid out by ``common.Placement`` from the reference's
logical axes: attention and the GLU as ``models.transformer`` splits
them; the SSD branch by head, a rank holding x_r ‖ z_r of ``w_in`` and
B_r ‖ C_r of ``w_bc`` (two pieces each, ``Spec.parts``), its heads' conv
channels, ``w_dt``, ``b_dt``, ``a_log`` and ``d_skip``, and its rows of
``w_out``, whose partial products are summed over ``model`` in fp32 and
rounded once (``common.row_parallel``); the embedding and head by vocab.
The two branch norms act on the summed ``d``-wide outputs, whole on every
rank. The cache holds the rank's kv heads (K/V, rings included) and heads
(conv and SSD states). Under ``fsdp`` each dense leaf is stored over
``data`` along its ``d_model`` dim and gathered a layer at a time (inside
the layer's checkpoint in training)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model, tp_of
from repro_torch.models.common import (
    Placement, Spec, add_rmsnorm, attention_decode, attention_decode_ring,
    attention_prefill, attention_train, attn_qkv, attn_specs, cache_update,
    chunked_loss, embed_specs, embed_tokens, glu_apply, glu_specs, init_tree,
    last_valid_slice, lm_head, ring_cache_update, rmsnorm, rope, rope_tables,
    row_parallel, silu, stacked, unstack, with_remat,
)
from repro_torch.models.linear_core import (
    chunked_linear_attention, linear_attention_step, pad_mask_gates,
)


def _ssd_specs(d: int, nh: int, hd: int, ds: int,
               conv_w: int) -> Dict[str, Spec]:
    """The SSD branch's leaves with the reference's logical axes. ``w_in``
    holds x ‖ z and ``w_bc`` B ‖ C, so their head dim is two pieces
    (``parts``): on a mesh a rank holds x_r ‖ z_r and B_r ‖ C_r, the
    pieces of its own heads, and runs the branch on them as one device
    runs all of them."""
    d_inner = nh * hd
    return {
        "w_in": Spec((d, 2 * d_inner), fan_in=d, axes=("fsdp", "heads"),
                     parts=(1, 2)),
        "conv": Spec((conv_w, d_inner), fan_in=conv_w, axes=(None, "heads")),
        "w_bc": Spec((d, 2 * nh * ds), fan_in=d, axes=("fsdp", "heads"),
                     parts=(1, 2)),
        "w_dt": Spec((d, nh), fan_in=d, dtype=torch.float32,
                     axes=("fsdp", "heads")),
        "b_dt": Spec((nh,), "zeros", dtype=torch.float32, axes=("heads",)),
        "a_log": Spec((nh,), "zeros", dtype=torch.float32, axes=("heads",)),
        "d_skip": Spec((nh,), "zeros", dtype=torch.float32, axes=("heads",)),
        "w_out": Spec((d_inner, d), fan_in=d_inner, axes=("heads", "fsdp")),
    }


def _causal_conv(x, kern, state=None, vl=None):
    """Depthwise causal conv by shifts. x: [B,S,C]; kern: [W,C]; state:
    [B,W-1,C], the trailing inputs of the previous segment. Returns
    (silu(conv), new state).

    vl: per-sample valid length of a right-padded x; the carried state is
    then each sample's last W-1 *valid* inputs (row t of x is row t + W-1
    of the padded buffer), not the padding's tail."""
    B, S, C = x.shape
    W = kern.shape[0]
    if state is None:
        pad = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, j:j + S] * kern[j] for j in range(W))
    if vl is None or W == 1:
        new_state = xp[:, xp.shape[1] - (W - 1):]
    else:
        idx = vl.long()[:, None] + torch.arange(W - 1, device=x.device)
        new_state = torch.gather(xp, 1, idx[:, :, None].expand(B, W - 1, C))
    return silu(y), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as it lowers, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssd_gates(p, x):
    """(log_f, log_i) from dt, fp32: log_f = -dt * exp(a_log) <= 0,
    log_i = log(dt), dt = softplus(x @ w_dt + b_dt) clipped to [1e-4, 8]."""
    dt = _softplus(x.float() @ p["w_dt"] + p["b_dt"]).clamp(1e-4, 8.0)
    return -dt * torch.exp(p["a_log"]), torch.log(dt)


def _ssd_dims(p) -> Tuple[int, int, int]:
    """(heads, state size, head dim) of an SSD branch's weights."""
    nh = p["w_dt"].shape[1]
    return nh, p["w_bc"].shape[1] // (2 * nh), p["w_in"].shape[1] // (2 * nh)


def _ssd_out(p, y, v, z, axes=(), mesh=None):
    """D-skip, silu gate and out-projection of the scan output ``y``
    (shaped like ``v``, [..., H, D]); z: [B, S, d_inner]. Where ``axes``
    split the heads, ``w_out`` holds this rank's rows
    (``common.row_parallel``)."""
    y = y + v * p["d_skip"].to(v.dtype)[:, None]
    return row_parallel(y.reshape(z.shape) * silu(z), p["w_out"], axes,
                        mesh=mesh)


def _ssd_seq(p, x, state, chunk: int, vl=None, train: bool = False,
             axes=(), mesh=None):
    """SSD branch over a sequence ``x`` [B,S,d]. state: (conv_state, S
    [B,H,ds,D] fp32), either None for zeros. Returns (branch output,
    (conv_state, S)); ``train``: the plain scan. The heads are the ones
    ``p`` holds (a rank's where ``axes`` split them)."""
    B, S, _ = x.shape
    nh, ds, hd = _ssd_dims(p)
    conv_state, Sm = state
    up = x @ p["w_in"]
    xin, z = up.split(nh * hd, dim=-1)
    xin, conv_state = _causal_conv(xin, p["conv"], conv_state, vl=vl)
    b, c = (t.reshape(B, S, nh, ds).contiguous()
            for t in (x @ p["w_bc"]).split(nh * ds, dim=-1))
    log_f, log_i = _ssd_gates(p, x)
    if vl is not None:
        log_f, log_i = pad_mask_gates(log_f, log_i, vl)
    v = xin.view(B, S, nh, hd)
    y, Sm = chunked_linear_attention(c, b, v, log_f, log_i, chunk=chunk,
                                     initial_state=Sm, train=train)
    return _ssd_out(p, y, v, z, axes, mesh), (conv_state, Sm)


def _ssd_step(p, x, state, axes=(), mesh=None):
    """One token ``x`` [B,1,d]; updates ``state`` (conv_state, S) in
    place and returns the branch output."""
    B = x.shape[0]
    nh, ds, hd = _ssd_dims(p)
    conv_state, Sm = state
    xin, z = (x @ p["w_in"]).split(nh * hd, dim=-1)
    # the new conv state is a view of the concatenation, not of the state
    # itself, so the shift by one row copies between distinct buffers
    xin, new_conv = _causal_conv(xin, p["conv"], conv_state)
    conv_state.copy_(new_conv)
    b, c = (t.reshape(B, nh, ds)
            for t in (x[:, 0] @ p["w_bc"]).split(nh * ds, dim=-1))
    log_f, log_i = _ssd_gates(p, x[:, 0])
    v = xin.view(B, nh, hd)
    y, _ = linear_attention_step(Sm, c, b, v, log_f, log_i)
    return _ssd_out(p, y, v, z, axes, mesh)


def _segments(cfg: ModelConfig) -> List[int]:
    """Sliding-window segment lengths after each global layer."""
    gl = sorted(cfg.global_layers)
    if not gl or gl[0] != 0:
        raise ValueError("hymba expects a leading global layer")
    return [b - a - 1 for a, b in zip(gl, gl[1:] + [cfg.num_layers])]


def build(cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype,
          remat: str = "full", chunk: int = 256, mesh=None,
          rules=None) -> Model:
    pd = cfg.padded(tp_of(mesh))
    nq, nkv, hd, V = pd.num_q_heads, pd.num_kv_heads, pd.head_dim, pd.vocab_size
    d, L, eps = cfg.d_model, cfg.num_layers, cfg.norm_eps
    ds, conv_w, W = cfg.ssm_state, cfg.conv_width, cfg.window
    n_global = len(cfg.global_layers)
    segs = _segments(cfg)
    n_swa = L - n_global

    layer_specs = {
        "ln": Spec((d,), "ones"),
        "attn": attn_specs(d, nq, nkv, hd, cfg.qkv_bias),
        "ssd": _ssd_specs(d, nq, hd, ds, conv_w),
        "ln_attn": Spec((d,), "ones"),
        "ln_ssd": Spec((d,), "ones"),
        "ln2": Spec((d,), "ones"),
        "ffn": glu_specs(d, cfg.d_ff),
    }
    specs = {
        "embed": embed_specs(V, d),
        "g": stacked(layer_specs, n_global),       # global-attention layers
        "swa": stacked(layer_specs, n_swa),        # sliding-window layers
    }
    place = Placement(mesh, rules, specs)
    # this rank's heads (attention and SSD alike) and kv heads
    heads_ax, kv_ax, ffn_ax, vocab_ax = (place.split[k] for k in (
        "heads", "kv_heads", "ffn", "vocab"))
    nq_l = nq // place.size(heads_ax)
    nkv_l = nkv // place.size(kv_ax)
    d_inner_l = nq_l * hd

    def init(gen: torch.Generator):
        """Seeded parameters on the model's device (``gen`` lives there):
        on a mesh, this rank's blocks of the one-device draw."""
        return init_tree(gen, specs, device, dtype, place.blocks)

    def _layers(params, gather: bool = True):
        """(kind, index in its stack, layer params) in execution order:
        each global layer, then its segment of sliding-window layers; the
        dense leaves gathered where the layout says (``gather``)."""
        g = unstack(params["g"], n_global)
        swa = unstack(params["swa"], n_swa)
        lo = 0
        for gi in range(n_global):
            yield "g", gi, _gathered(g[gi], "g") if gather else g[gi]
            for i in range(lo, lo + segs[gi]):
                yield "w", i, _gathered(swa[i], "w") if gather else swa[i]
            lo += segs[gi]

    def _gathered(lp, kind: str):
        """One layer's leaves, whole along the dims its layout gathers."""
        return place.gathered(lp, "g" if kind == "g" else "swa", layer=True)

    def _attn_out(lp, o):
        """The attention output ``o`` [B, S, heads, D] projected to ``d``
        (summed over the ranks that split the heads)."""
        B, S = o.shape[:2]
        return row_parallel(o.reshape(B, S, nq_l * hd), lp["attn"]["wo"],
                            heads_ax, mesh=mesh)

    def _mix_ffn(lp, x, a_out, s_out, train: bool = False):
        """Per-branch norms averaged into the residual, second norm, FFN;
        returns the residual and the FFN's output, not yet added. The norms
        act on the ``d``-wide branch outputs, whole on every rank."""
        mix = 0.5 * (rmsnorm(a_out, lp["ln_attn"], eps, train=train)
                     + rmsnorm(s_out, lp["ln_ssd"], eps, train=train))
        x, h2 = add_rmsnorm(x, mix, lp["ln2"], eps, train=train)
        return x, glu_apply(lp["ffn"], h2, ffn_ax, mesh=mesh)

    # ---------------- train ----------------
    def layer_train(x, lp, tables, window: int, kind: str):
        """One block of the training forward from zero conv / SSD states;
        the layer gathers its weights inside its checkpoint."""
        lp = _gathered(lp, kind)
        h = rmsnorm(x, lp["ln"], eps, train=True)
        q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
        q, k = rope(q, tables), rope(k, tables)
        o = attention_train(q, k, v, causal=True, window=window)
        s_out, _ = _ssd_seq(lp["ssd"], h, (None, None), chunk, train=True,
                            axes=heads_ax, mesh=mesh)
        x, y = _mix_ffn(lp, x, _attn_out(lp, o), s_out, train=True)
        return x + y

    layer = with_remat(layer_train, remat)

    def loss_fn(params, batch):
        """batch: ``tokens``, ``labels`` [B,S] -> mean cross-entropy, fp32."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        tables = rope_tables(torch.arange(x.shape[1], device=device)[None],
                             hd, cfg.rope_theta)
        for kind, _, lp in _layers(params, gather=False):
            x = layer(x, lp, tables, W if kind == "w" else 0, kind)
        return chunked_loss(embed, x, batch["labels"], eps, axes=vocab_ax,
                            mesh=mesh)

    # ---------------- prefill ----------------
    def prefill(params, batch, max_len: Optional[int] = None):
        """batch: ``tokens`` [B,S] and optional per-sample ``lengths`` [B]
        (right-padded prompts, S <= W). Returns last-token logits [B,V]
        (this rank's vocab block where ``extras["vocab_axes"]`` split it)
        and the cache, its global K/V padded to ``max_len`` positions.
        Past the window an exact prompt's last W rows land in ring
        order."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        B, S, _ = x.shape
        vl = batch.get("lengths")
        # padded prefill needs the ring not to wrap: the junk tail slots
        # [vl, S) are the ones decode overwrites before its valid count
        # reaches them; a wrapped ring would put junk on live slots (the
        # engine caps the ladder at W through ``prompt_pad_cap``)
        if vl is not None and S > W:
            raise ValueError(f"padded prefill needs a prompt bucket <= the "
                             f"window ({S} > {W})")
        cache = init_cache(B, max_len or S)
        tables = rope_tables(torch.arange(S, device=device)[None, :], hd,
                             cfg.rope_theta)
        for kind, i, lp in _layers(params):
            h = rmsnorm(x, lp["ln"], eps)
            q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
            q, k = rope(q, tables), rope(k, tables)
            o = attention_prefill(q, k, v, causal=True,
                                  window=W if kind == "w" else 0,
                                  kv_valid=vl)
            conv_s, ssd_s = cache["conv_" + kind][i], cache["ssd_" + kind][i]
            s_out, (conv_new, ssd_new) = _ssd_seq(
                lp["ssd"], h, (conv_s, ssd_s), chunk, vl, axes=heads_ax,
                mesh=mesh)
            x, y = _mix_ffn(lp, x, _attn_out(lp, o), s_out)
            x = x + y
            conv_s.copy_(conv_new)
            ssd_s.copy_(ssd_new)
            kc, vc = cache["k" + kind][i], cache["v" + kind][i]
            if kind == "w" and S > W:   # ring: position p lives at slot p % W
                kc.copy_(torch.roll(k[:, -W:], S % W, 1))
                vc.copy_(torch.roll(v[:, -W:], S % W, 1))
            else:                       # no wrap: position p at slot p
                kc[:, :S] = k
                vc[:, :S] = v
        x_last = (x[:, -1:].contiguous() if vl is None
                  else last_valid_slice(x, vl))
        logits = lm_head(embed, x_last, eps)[:, 0]
        cache["lengths"] = (torch.full((B,), S, dtype=torch.int32,
                                       device=device)
                            if vl is None else vl.to(torch.int32))
        return logits, cache

    # ---------------- decode ----------------
    def decode_step(params, cache, tokens, lengths):
        """tokens: [B,1]; lengths: [B] int32 tokens seen per sample. Updates
        every leaf of ``cache`` in place and returns it with ``lengths +
        1``; ring slots and counts are computed on the device."""
        emb = place.gathered(params["embed"], "embed")
        x = embed_tokens(emb, tokens, vocab_ax, mesh=mesh)
        tables = rope_tables(lengths[:, None], hd, cfg.rope_theta)
        leaves = {name: torch.unbind(cache[name], 0)
                  for name in ("kg", "vg", "kw", "vw", "conv_g", "ssd_g",
                               "conv_w", "ssd_w")}
        y = None
        for kind, i, lp in _layers(params):
            if y is not None:
                x = x + y
            h = rmsnorm(x, lp["ln"], eps)
            q, k, v = attn_qkv(lp["attn"], h, nq_l, nkv_l, hd)
            q, k = rope(q, tables), rope(k, tables)
            kc, vc = leaves["k" + kind][i], leaves["v" + kind][i]
            if kind == "w":
                ring_cache_update(kc, vc, k, v, lengths)
                o = attention_decode_ring(q, kc, vc, lengths)
            else:
                cache_update(kc, vc, k, v, lengths)
                o = attention_decode(q, kc, vc, lengths + 1)
            s_out = _ssd_step(lp["ssd"], h, (leaves["conv_" + kind][i],
                                             leaves["ssd_" + kind][i]),
                              heads_ax, mesh)
            x, y = _mix_ffn(lp, x, _attn_out(lp, o), s_out)
        if segs[-1]:
            # the last layer is a scanned sliding-window layer: the
            # reference rounds its output, the scan's carry, to bf16
            logits = lm_head(emb, x + y, eps)
        else:
            # the last layer is an unrolled global layer: compiled, its
            # residual add fuses into the final norm, which reads the sum
            # unrounded
            logits = add_rmsnorm(x, y, emb["final_norm"], eps)[1] @ emb["head"]
        return logits[:, 0], dict(cache, lengths=lengths + 1)

    def init_cache(batch: int, max_len: int):
        """Every slot's cache, of this rank's kv heads (K/V) and heads (the
        conv and SSD states)."""
        def z(n, *shape, dt=dtype):
            return torch.zeros((n, batch) + shape, dtype=dt, device=device)

        return {
            "kg": z(n_global, max_len, nkv_l, hd),
            "vg": z(n_global, max_len, nkv_l, hd),
            "kw": z(n_swa, W, nkv_l, hd), "vw": z(n_swa, W, nkv_l, hd),
            "conv_g": z(n_global, conv_w - 1, d_inner_l),
            "ssd_g": z(n_global, nq_l, ds, hd, dt=torch.float32),
            "conv_w": z(n_swa, conv_w - 1, d_inner_l),
            "ssd_w": z(n_swa, nq_l, ds, hd, dt=torch.float32),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
        }

    return Model(
        cfg=cfg, device=device, dtype=dtype, init=init, prefill=prefill,
        decode_step=decode_step, init_cache=init_cache, loss_fn=loss_fn,
        # prompt padding is exact (masked SSD gates, per-sample conv state)
        # only while the padded bucket stays within the window
        extras={"padded": pd, "segments": segs,
                "prompt_pad": True, "prompt_pad_cap": W, **place.extras()},
    )
