"""Mixture-of-Experts FFN, single-device dispatch.

Port of ``repro.models.moe`` with one device holding every expert: the
reference's ``shard_map`` bodies collapse to its local path with ``tp = 1``,
``num_local = E`` and ``e_lo = 0``. Routing is top-k softmax with capacity
(sort-based ranking, no [T, E] one-hot), token dropping, and the
switch-style load-balancing aux loss.

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
from typing import Dict, NamedTuple

import torch

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
        "wi": Spec((num_experts, d_model, d_ff), fan_in=d_model),
        "wg": Spec((num_experts, d_model, d_ff), fan_in=d_model),
        "wo": Spec((num_experts, d_ff, d_model), fan_in=d_ff),
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


def moe_apply(params, x: torch.Tensor, dims: MoEDims):
    """MoE FFN on one device. x: [B, S, d] -> (y [B, S, d], aux). Capacity
    counts every token of the call, padding and inactive decode slots
    included, as in the reference."""
    B, S, d = x.shape
    T = B * S
    y, aux = _moe_local(x.reshape(T, d), params, dims, 0, dims.num_experts,
                        _capacity(T, dims))
    return y.view(B, S, d), aux
