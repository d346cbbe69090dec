"""xLSTM, ssm family: pair-scanned (mLSTM, sLSTM) blocks, 12 layers = 6 pairs.

Port of ``repro.models.xlstm``. mLSTM keeps a matrix
memory ``[hd, hd]`` per head (plus its normalizer ``[hd]``) and runs a prompt
through the chunked linear-attention core, which routes to the ``ssd_scan``
kernel; sLSTM is a scalar-memory recurrence with a hidden-state feedback,
run step by step in fp32 (its input projection is one GEMM over the whole
prompt, hoisted out of the time loop).

``loss_fn`` runs the same sequence path from a zero state with the plain
RMSNorm and the plain chunked scan (``train=True``), each pair under
``remat``, then ``chunked_loss``.

Parameters keep the reference's tree, ``{"embed": {...}, "pairs": {"m":
{...}, "s": {...}}}`` with every pair leaf stacked on a leading ``[npairs]``
axis; the gate weights are fp32. The decode state is the cache
``{"m": (S [npairs,B,nh,hd,hd], n [npairs,B,nh,hd]), "s": (c, n, h, m) each
[npairs,B,d], "lengths": [B]}``, all fp32 but ``lengths``. ``decode_step``
updates every state leaf of the cache it is given in place (the
counterpart of the reference's donated cache) and returns it.

On a mesh (``build(..., mesh=, rules=)``) ``common.Placement`` lays the
leaves out by the reference's logical axes: the embedding and head split
by vocab over ``model`` (the logits a rank's vocab block, the loss's
logsumexp taken over the ranks); the pairs' leaves name no ``model`` axis
and stay whole over it (at 125 M parameters the reference leaves
``model`` idle for them), and under ``fsdp`` each is stored over ``data``
along its ``fsdp`` dim and gathered a pair at a time."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import softmax_scale
from repro_torch.models.api import Model, tp_of
from repro_torch.models.common import (
    Placement, Spec, add_rmsnorm, chunked_loss, embed_specs, embed_tokens, init_tree,
    last_valid_slice, lm_head, rmsnorm, silu, stacked, unstack, with_remat,
)
from repro_torch.models.linear_core import (
    chunked_linear_attention, linear_attention_step, normalized_readout,
    pad_mask_gates,
)


def _mlstm_specs(d: int, nh: int, d_in: int, hd: int) -> Dict[str, Spec]:
    return {
        "ln": Spec((d,), "ones"),
        "w_up": Spec((d, 2 * d_in), fan_in=d, axes=("fsdp", None)),
        "wq": Spec((d_in, nh, hd), fan_in=d_in, axes=("fsdp", None, None)),
        "wk": Spec((d_in, nh, hd), fan_in=d_in, axes=("fsdp", None, None)),
        "wv": Spec((d_in, nh, hd), fan_in=d_in, axes=("fsdp", None, None)),
        "w_gates": Spec((d_in, 2 * nh), fan_in=d_in, dtype=torch.float32,
                        axes=("fsdp", None)),
        "b_gates": Spec((2 * nh,), "zeros", dtype=torch.float32),
        "w_down": Spec((d_in, d), fan_in=d_in, axes=(None, "fsdp")),
    }


def _slstm_specs(d: int) -> Dict[str, Spec]:
    return {
        "ln": Spec((d,), "ones"),
        "w": Spec((d, 4 * d), fan_in=d, axes=("fsdp", None)),
        "r": Spec((d, 4 * d), fan_in=d, axes=("fsdp", None)),
        "b": Spec((4 * d,), "zeros"),
        "w_out": Spec((d, d), fan_in=d, axes=("fsdp", None)),
    }


def _mlstm_gates(p, c_in):
    """Returns (log_f, log_i) per head, both <= ~0 (sigmoid gating)."""
    raw = c_in.float() @ p["w_gates"] + p["b_gates"]
    nh = raw.shape[-1] // 2
    log_f = F.logsigmoid(raw[..., :nh] + 4.0)   # bias toward remembering
    log_i = F.logsigmoid(raw[..., nh:])
    return log_f, log_i


def _mlstm_qkv(p, c_in, scale: float):
    """q, k, v [B,S,nh,hd]; ``scale`` multiplies q and k (rounded to the
    working dtype first, as JAX rounds a Python float)."""
    B, S, _ = c_in.shape
    nh, hd = p["wq"].shape[1], p["wq"].shape[2]

    def proj(w):
        return (c_in @ w.reshape(w.shape[0], nh * hd)).view(B, S, nh, hd)

    return proj(p["wq"]) * scale, proj(p["wk"]) * scale, proj(p["wv"])


def _mlstm_up(p, h):
    up = h @ p["w_up"]
    d_in = up.shape[-1] // 2
    return up[..., :d_in], up[..., d_in:]


def _mlstm_out(p, y, z):
    """Output gate and down projection of the normalized readout ``y``
    [B,S,nh,hd]: ``y * silu(z) @ w_down``."""
    B, S = z.shape[:2]
    return (y.reshape(B, S, -1) * silu(z)) @ p["w_down"]


def _mlstm_seq(p, h, state, chunk: int, scale: float, vl=None,
               train: bool = False):
    """Full-sequence mLSTM branch on the normed input ``h`` [B,S,d]. state:
    (S [B,nh,hd,hd], n [B,nh,hd]). Returns (branch output, new state);
    ``train``: the plain scan."""
    c_in, z = _mlstm_up(p, h)
    q, k, v = _mlstm_qkv(p, c_in, scale)
    log_f, log_i = _mlstm_gates(p, c_in)
    if vl is not None:
        log_f, log_i = pad_mask_gates(log_f, log_i, vl)
    # one scan for the memory and its normalizer: v augmented by a ones
    # column, the state by the normalizer column (state columns are
    # independent, so this is the reference's two scans in one)
    Sm, Nm = state
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    y_aug, st = chunked_linear_attention(
        q, k, torch.cat((v, ones), -1), log_f, log_i, chunk=chunk,
        initial_state=torch.cat((Sm, Nm[..., None]), -1), train=train)
    return (_mlstm_out(p, normalized_readout(y_aug), z),
            (st[..., :-1], st[..., -1]))


def _mlstm_step(p, h, state, scale: float):
    """One-token mLSTM branch on the normed input ``h`` [B,1,d]; updates
    ``state`` (S [B,nh,hd,hd], n [B,nh,hd]) in place."""
    B = h.shape[0]
    c_in, z = _mlstm_up(p, h)
    q, k, v = _mlstm_qkv(p, c_in, scale)
    log_f, log_i = _mlstm_gates(p, c_in)
    Sm, Nm = state
    nh = q.shape[2]
    y, _ = linear_attention_step(Sm, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                                 log_i[:, 0])
    nrm, _ = linear_attention_step(
        Nm[..., None], q[:, 0], k[:, 0],
        torch.ones((B, nh, 1), dtype=v.dtype, device=v.device),
        log_f[:, 0], log_i[:, 0])
    y = y / nrm.abs().clamp_min(1.0).to(y.dtype)     # normalized_readout
    return _mlstm_out(p, y[:, None], z)


def _slstm_cell(pre, r, b, carry):
    """One sLSTM step. pre: ``x_t @ w`` [B,4d] fp32; carry: (c, n, h, m)
    each [B,d] fp32. Returns (new carry, h_new)."""
    c, n, h, m = carry
    raw = (pre + h @ r) + b
    zi, ii, fi, oi = raw.chunk(4, dim=-1)
    log_f = F.logsigmoid(fi + 4.0)
    log_i = F.logsigmoid(ii)
    m_new = torch.maximum(log_f + m, log_i)
    fp = torch.exp(log_f + m - m_new)
    ip = torch.exp(log_i - m_new)
    c = fp * c + ip * torch.tanh(zi)
    n = fp * n + ip
    h_new = torch.sigmoid(oi) * c / n.clamp_min(1.0)
    return (c, n, h_new, m_new), h_new


def _slstm_weights(p):
    return p["w"].float(), p["r"].float(), p["b"].float()


def _slstm_seq(p, h0, state, vl=None):
    """Full-sequence sLSTM branch on the normed input ``h0`` [B,S,d]; a time
    loop in fp32. Padded steps (t >= vl[b]) keep the whole carry (gate
    masking alone cannot preserve h). Returns (branch output, new state)."""
    B, S, d = h0.shape
    w, r, b = _slstm_weights(p)
    pre = h0.float() @ w                      # [B,S,4d], the same GEMM per step
    hs = []
    valid = None
    if vl is not None:
        valid = (torch.arange(S, device=h0.device)[:, None]
                 < vl[None, :])[..., None]     # [S,B,1]
    carry = tuple(state)
    for t in range(S):
        new, h_t = _slstm_cell(pre[:, t], r, b, carry)
        hs.append(h_t)
        if valid is None:
            carry = new
        else:
            carry = tuple(torch.where(valid[t], a, o)
                          for a, o in zip(new, carry))
    return torch.stack(hs, 1).to(h0.dtype) @ p["w_out"], carry


def _slstm_step(p, h, state):
    """One-token sLSTM branch on the normed input ``h`` [B,1,d]; updates
    ``state`` (c, n, h, m) in place."""
    w, r, b = _slstm_weights(p)
    new, h_t = _slstm_cell(h[:, 0].float() @ w, r, b, tuple(state))
    for dst, src in zip(state, new):
        dst.copy_(src)
    return (h_t.to(h.dtype) @ p["w_out"])[:, None, :]


def build(cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype,
          remat: str = "full", chunk: int = 256, mesh=None,
          rules=None) -> Model:
    d, L = cfg.d_model, cfg.num_layers
    if L % 2:
        raise ValueError("xlstm pair-scan needs an even layer count")
    npairs = L // 2
    nh = cfg.num_heads
    d_in = 2 * d
    hd = d_in // nh
    eps = cfg.norm_eps
    V = cfg.padded(tp_of(mesh)).vocab_size
    scale = softmax_scale(hd ** -0.5, hd, dtype)

    pair_specs = {"m": _mlstm_specs(d, nh, d_in, hd), "s": _slstm_specs(d)}
    specs = {"embed": embed_specs(V, d), "pairs": stacked(pair_specs, npairs)}
    place = Placement(mesh, rules, specs)
    vocab_ax = place.split["vocab"]

    def init(gen: torch.Generator):
        """Seeded parameters on the model's device (``gen`` lives there):
        on a mesh, this rank's blocks of the one-device draw."""
        return init_tree(gen, specs, device, dtype, place.blocks)

    def _pairs(params, gather: bool = True):
        """Each pair's leaves as it uses them: the views of its slice of
        the stack, gathered over ``data`` where ``fsdp`` stores them."""
        for pp in unstack(params["pairs"], npairs):
            yield place.gathered(pp, "pairs", layer=True) if gather else pp

    def _zero_state(B: int, n: int = npairs):
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return {"m": (z(n, B, nh, hd, hd), z(n, B, nh, hd)),
                "s": tuple(z(n, B, d) for _ in range(4))}

    def _layer(state, i: int):
        return ((state["m"][0][i], state["m"][1][i]),
                tuple(s[i] for s in state["s"]))

    def pair_train(x, pp):
        """One (mLSTM, sLSTM) pair of the training forward from a zero
        state; the pair gathers its weights inside its checkpoint."""
        pp = place.gathered(pp, "pairs", layer=True)
        st = _zero_state(x.shape[0], 1)
        mst, sst = _layer(st, 0)
        dm, _ = _mlstm_seq(pp["m"], rmsnorm(x, pp["m"]["ln"], train=True),
                           mst, chunk, scale, train=True)
        x, h = add_rmsnorm(x, dm, pp["s"]["ln"], train=True)
        return x + _slstm_seq(pp["s"], h, sst)[0]

    pair = with_remat(pair_train, remat)

    def loss_fn(params, batch):
        """batch: ``tokens``, ``labels`` [B,S] -> mean cross-entropy, fp32."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        for pp in _pairs(params, gather=False):
            x = pair(x, pp)
        return chunked_loss(embed, x, batch["labels"], eps, axes=vocab_ax,
                            mesh=mesh)

    def prefill(params, batch, max_len: Optional[int] = None):
        """batch: ``tokens`` [B,S] and optional per-sample ``lengths`` [B]
        (right-padded prompts; S a multiple of ``min(chunk, S)``). Returns
        last-token logits [B,V] (this rank's vocab block where
        ``extras["vocab_axes"]`` split it) and the decode state
        (``max_len`` is unused: the state does not grow with the
        sequence)."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, batch["tokens"], vocab_ax, mesh=mesh)
        B, S, _ = x.shape
        vl = batch.get("lengths")
        state = _zero_state(B)
        for i, pp in enumerate(_pairs(params)):
            mst, sst = _layer(state, i)
            dm, (Sm, Nm) = _mlstm_seq(pp["m"], rmsnorm(x, pp["m"]["ln"]), mst,
                                      chunk, scale, vl)
            x, h = add_rmsnorm(x, dm, pp["s"]["ln"])
            ds, new_s = _slstm_seq(pp["s"], h, sst, vl)
            x = x + ds
            mst[0].copy_(Sm)
            mst[1].copy_(Nm)
            for dst, src in zip(sst, new_s):
                dst.copy_(src)
        x_last = (x[:, -1:].contiguous() if vl is None
                  else last_valid_slice(x, vl))
        logits = lm_head(embed, x_last, eps)[:, 0]
        state["lengths"] = (torch.full((B,), S, dtype=torch.int32,
                                       device=device)
                            if vl is None else vl.to(torch.int32))
        return logits, state

    def decode_step(params, cache, tokens, lengths):
        """tokens: [B,1]; lengths: [B] int32. Updates every state leaf of
        ``cache`` in place and returns it with ``lengths + 1``."""
        embed = place.gathered(params["embed"], "embed")
        x = embed_tokens(embed, tokens, vocab_ax, mesh=mesh)
        for i, pp in enumerate(_pairs(params)):
            mst, sst = _layer(cache, i)
            dm = _mlstm_step(pp["m"], rmsnorm(x, pp["m"]["ln"]), mst, scale)
            x, h = add_rmsnorm(x, dm, pp["s"]["ln"])
            x = x + _slstm_step(pp["s"], h, sst)
        logits = lm_head(embed, x, eps)[:, 0]
        return logits, {"m": cache["m"], "s": cache["s"],
                        "lengths": lengths + 1}

    def init_cache(batch: int, max_len: int):
        state = _zero_state(batch)
        state["lengths"] = torch.zeros((batch,), dtype=torch.int32,
                                       device=device)
        return state

    return Model(
        cfg=cfg, device=device, dtype=dtype, init=init, prefill=prefill,
        decode_step=decode_step, init_cache=init_cache, loss_fn=loss_fn,
        extras={"prompt_pad": True, **place.extras()},
    )
