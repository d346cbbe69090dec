"""Mixture-of-Experts FFN with expert parallelism.

Port of ``repro.models.moe``. Routing is top-k softmax with capacity
(sort-based ranking, no [T, E] one-hot), token dropping, and the
switch-style load-balancing aux loss.

Without a mesh one device holds every expert: the reference's ``shard_map``
bodies collapse to its local path with ``tp = 1``, ``num_local = E`` and
``e_lo = 0``. On a mesh (``launch.mesh`` over a ``torch.distributed``
world) each rank runs the reference's per-device body on its own tensors,
with the collectives of ``distributed.sharding``:

* ``ep`` (``_moe_body_ep``): experts split over ``model``, ``num_local =
  E / tp`` a rank from ``e_lo = axis_index("model") * num_local``; with an
  ``fsdp`` axis the expert weights' ``d_model`` dim is stored split and
  gathered per layer (ZeRO-3). Tokens replicated over ``model`` combine
  with one ``psum`` over ``model``; a batch split over ``model``
  (dp-major) is gathered over ``model`` first and the sum scattered back
  (``psum_scatter``);
* ``ep2d`` (``_moe_body_ep2d``): each expert's ``d_ff`` also split over
  ``ffn2d`` (``data``); token chunks are gathered over ``ffn2d``, the GLU
  runs on the local ``d_ff`` slice, one ``psum`` over ``(ffn2d, model)``
  combines, and each rank keeps its own rows.

The load-balancing term's collectives run only where it is used
(``need_aux``: the training forward), as the reference's compiler drops
them from a prefill that discards it.

The ops are chosen to give the reference's answers on both devices and to
keep the decode step free of host syncs, so that a CUDA graph can capture
it:

* top-k is a stable descending sort: ties go to the lower expert index, as
  ``lax.top_k`` breaks them (``torch.topk`` promises no order);
* dispatch ranks with ``argsort(stable=True)`` and ``cummax`` where the
  reference uses ``argsort(stable=True)`` and an associative max-scan;
* combine adds each token's k weighted expert outputs in the order the
  reference's scatter-add visits them, sorted by expert id, as k
  sequential adds in the working dtype: deterministic, where an
  ``index_add_`` on the card would add in the order of its atomics.

The expert GLU products stay batched matrix products (``torch.bmm``), as
the reference computes them with ``jnp.einsum`` outside any kernel."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models.common import Spec, silu


class MoEDims(NamedTuple):
    num_experts: int
    top_k: int
    capacity_factor: float
    d_model: int
    d_ff: int


def moe_specs(d_model: int, d_ff: int, num_experts: int) -> Dict[str, Spec]:
    return {
        "router": Spec((d_model, num_experts), fan_in=d_model,
                       dtype=torch.float32),
        "wi": Spec((num_experts, d_model, d_ff), fan_in=d_model,
                   axes=("expert", "fsdp", "expert_ffn"), draw="matrix"),
        "wg": Spec((num_experts, d_model, d_ff), fan_in=d_model,
                   axes=("expert", "fsdp", "expert_ffn"), draw="matrix"),
        "wo": Spec((num_experts, d_ff, d_model), fan_in=d_ff,
                   axes=("expert", "expert_ffn", "fsdp"), draw="matrix"),
    }


def _route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """Top-k softmax routing. x2d: [T, d] -> (weights [T, k] fp32, experts
    [T, k] int64, aux scalar)."""
    logits = x2d.float() @ router                         # [T, E]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_p, top_e = sorted_p[:, :top_k], sorted_e[:, :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = router.shape[1]
    counts = torch.zeros((E,), dtype=torch.float32, device=x2d.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones((top_e.numel(),), dtype=torch.float32,
                                 device=x2d.device))
    dispatch_frac = counts / (x2d.shape[0] * top_k)
    aux = E * torch.sum(dispatch_frac * probs.mean(dim=0))
    return top_p, top_e, aux


def _dispatch_indices(top_e: torch.Tensor, e_lo: int, e_hi: int,
                      capacity: int, num_local: int):
    """Sort-based capacity assignment for experts in [e_lo, e_hi).

    Returns (rows [N], slots [N], keep [N], order [N]) with N = T * k,
    in expert-sorted order: ``rows`` the source token, ``slots`` the row of
    a [num_local * capacity] buffer (the overflow row ``num_local *
    capacity`` where dropped)."""
    flat_e = top_e.reshape(-1)
    Tk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)               # group by expert
    sorted_e = flat_e[order]
    idx = torch.arange(Tk, device=top_e.device)
    same_as_prev = torch.cat([torch.zeros((1,), dtype=torch.bool,
                                          device=top_e.device),
                              sorted_e[1:] == sorted_e[:-1]])
    group_start = torch.where(same_as_prev, torch.zeros_like(idx), idx)
    group_start = torch.cummax(group_start, dim=0).values
    rank = idx - group_start
    local = (sorted_e >= e_lo) & (sorted_e < e_hi)
    keep = local & (rank < capacity)
    slot = (sorted_e - e_lo) * capacity + rank.clamp_max(capacity - 1)
    slot = torch.where(keep, slot, torch.full_like(slot,
                                                   num_local * capacity))
    rows = order // top_e.shape[1]                            # source token
    return rows, slot, keep, order


def _expert_glu(xb, wi, wg, wo):
    """xb: [E, C, d]; weights [E, d, dff] / [E, dff, d]."""
    return torch.bmm(silu(torch.bmm(xb, wg)) * torch.bmm(xb, wi), wo)


def _moe_local(x2d, params, dims: MoEDims, e_lo: int, num_local: int,
               capacity: int):
    """Route, dispatch, expert GLU and combine for [T, d] tokens. Returns
    ([T, d], aux)."""
    T, d = x2d.shape
    k = dims.top_k
    top_p, top_e, aux = _route(x2d, params["router"], k)
    rows, slot, keep, order = _dispatch_indices(
        top_e, e_lo, e_lo + num_local, capacity, num_local)
    n = num_local * capacity
    keep_col = keep[:, None]
    buf = torch.zeros((n + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[slot] = torch.where(keep_col, x2d[rows], torch.zeros((), dtype=x2d.dtype,
                                                             device=x2d.device))
    yb = _expert_glu(buf[:-1].view(num_local, capacity, d), params["wi"],
                     params["wg"], params["wo"]).reshape(n, d)
    w = top_p.reshape(-1)[order]
    contrib = torch.where(keep_col, yb[slot.clamp_max(n - 1)]
                          * w[:, None].to(yb.dtype),
                          torch.zeros((), dtype=yb.dtype, device=yb.device))
    # back to (token, choice) order, then each token's choices by expert id
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib
    per_tok = per_tok.view(T, k, d)
    by_expert = torch.argsort(top_e, dim=-1)
    per_tok = per_tok.gather(1, by_expert[:, :, None].expand(T, k, d))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y, aux


def _capacity(tokens: int, dims: MoEDims) -> int:
    c = int(math.ceil(tokens * dims.top_k * dims.capacity_factor
                      / dims.num_experts))
    return max(4, c)


def moe_apply(params, x: torch.Tensor, dims: MoEDims, *, mesh=None,
              batch_axes: Tuple[str, ...] = (),
              fsdp_axis: Optional[str] = None,
              ffn2d_axis: Optional[str] = None, chunk_tokens: int = 4096,
              need_aux: bool = True):
    """MoE FFN. x: [B, S, d] (this rank's rows of a batch split over
    ``batch_axes``) -> (y [B, S, d], aux). Capacity counts every token of
    the call, padding and inactive decode slots included, as in the
    reference. Without a mesh: one device, every expert."""
    B, S, d = x.shape
    if mesh is None:
        T = B * S
        y, aux = _moe_local(x.reshape(T, d), params, dims, 0,
                            dims.num_experts, _capacity(T, dims))
        return y.view(B, S, d), aux
    tp = mesh.shape["model"]
    if dims.num_experts % tp:
        raise ValueError(f"{dims.num_experts} experts do not split over "
                         f"model = {tp}")
    num_local = dims.num_experts // tp
    if ffn2d_axis is None:
        return _moe_body_ep(params, x, dims, mesh, num_local, fsdp_axis,
                            batch_axes, need_aux)
    return _moe_body_ep2d(params, x, dims, mesh, num_local, ffn2d_axis,
                          chunk_tokens, batch_axes, need_aux)


def _moe_body_ep(params, x, dims: MoEDims, mesh, num_local: int, fsdp_axis,
                 batch_axes, need_aux: bool):
    """Per-rank body, mode ``ep`` (ref ``moe.py:169-202``). Standard: x
    replicated over model, combined by one psum. Dp-major: the batch itself
    split over model, gathered over the model column so each expert-owning
    rank serves every token, the sum scattered back."""
    gather_model = "model" in batch_axes
    if fsdp_axis is not None:   # ZeRO-3: gather this layer's expert weights
        params = dict(params)
        for k in ("wi", "wg"):
            params[k] = sh.all_gather(params[k], fsdp_axis, 1, mesh=mesh)
        params["wo"] = sh.all_gather(params["wo"], fsdp_axis, 2, mesh=mesh)
    B, S, d = x.shape
    if gather_model:
        x = sh.all_gather(x, "model", 0, mesh=mesh)       # [B * tp, S, d]
    Bg = x.shape[0]
    T = Bg * S
    e_lo = sh.axis_index("model", mesh=mesh) * num_local
    y, aux = _moe_local(x.reshape(T, d), params, dims, e_lo, num_local,
                        _capacity(T, dims))
    if gather_model:
        y = sh.psum_scatter(y.view(Bg, S, d), "model", 0, mesh=mesh)
    else:
        y = sh.psum(y, "model", mesh=mesh).view(Bg, S, d)
    if need_aux:
        # routing is identical across model ranks; mean over the batch
        aux = (sh.psum(aux, "model", mesh=mesh)
               / sh.axis_size("model", mesh=mesh))
        if batch_axes:
            aux = sh.pmean(aux, batch_axes, mesh=mesh)
    return y.reshape(B, S, d), aux


def _moe_body_ep2d(params, x, dims: MoEDims, mesh, num_local: int,
                   ffn2d_axis: str, chunk_tokens: int, batch_axes,
                   need_aux: bool):
    """Per-rank body, mode ``ep2d`` (ref ``moe.py:205-237``): expert d_ff
    split over ``ffn2d_axis``; token chunks gathered over it, the GLU on
    the local d_ff slice, one psum over (ffn2d, model), this rank's rows
    kept."""
    B, S, d = x.shape
    T = B * S
    dp = sh.axis_size(ffn2d_axis, mesh=mesh)
    mine = sh.axis_index(ffn2d_axis, mesh=mesh)
    e_lo = sh.axis_index("model", mesh=mesh) * num_local
    nchunks = max(1, (T + chunk_tokens - 1) // chunk_tokens)
    while T % nchunks:
        nchunks += 1
    csize = T // nchunks
    x2d = x.reshape(T, d)
    ys = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(nchunks):
        xc = sh.all_gather(x2d[ci * csize:(ci + 1) * csize], ffn2d_axis, 0,
                           mesh=mesh)                      # [csize * dp, d]
        yc, a = _moe_local(xc, params, dims, e_lo, num_local,
                           _capacity(csize * dp, dims))
        yc = sh.psum(yc, (ffn2d_axis, "model"), mesh=mesh)
        ys.append(yc[mine * csize:(mine + 1) * csize])
        aux = aux + a
    y = ys[0] if nchunks == 1 else torch.cat(ys)
    aux = aux / nchunks
    if need_aux and batch_axes:
        aux = sh.pmean(aux, batch_axes, mesh=mesh)
    return y.reshape(B, S, d), aux
