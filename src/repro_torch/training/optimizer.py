"""Optimizers written as functions on tensor trees (port of
``repro.training.optimizer``).

AdamW keeps fp32 moments and fp32 master weights for bf16 params (mixed
precision); Adafactor is the low-memory alternative. The states are the
reference's NamedTuples with its field names, and their trees mirror the
param tree, so a checkpoint of either package restores in the other.
Every update runs on the params' device with no host sync."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.tree import (
    flatten_with_paths, leaves, tree_map, unflatten_like,
)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any
    v: Any
    master: Any          # fp32 master copy of params


def _square_sums(grads, specs=None, mesh=None) -> List[torch.Tensor]:
    """Each leaf's sum of squares over the whole leaf: where ``specs``
    (``{leaf path: PartitionSpec}``) splits a leaf over ``mesh`` axes,
    its ranks' sums are added (one all-reduce per set of axes)."""
    flat = flatten_with_paths(grads)
    sq = [torch.sum(torch.square(g.float())) for _, g in flat]
    by_axes: Dict[tuple, list] = {}
    for i, (path, _) in enumerate(flat):
        axes = mesh.axes(tuple(a for e in (specs or {}).get(path, ())
                               for a in sh.norm_axes(e))) if mesh else ()
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        tot = sh.psum(torch.stack([sq[i] for i in idx]), axes, mesh=mesh)
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return sq


def adamw_init(params) -> AdamWState:
    return AdamWState(
        step=_step0(params), m=tree_map(_f32_zeros, params),
        v=tree_map(_f32_zeros, params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params))


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0, specs=None,
                 mesh=None):
    """-> (new params in their dtypes, new state, global grad norm).
    ``specs``, ``mesh``: the leaves split over a mesh's ranks, whose norm
    is that of the whole leaf (``_square_sums``)."""
    step = state.step + 1
    sq = _square_sums(grads, specs, mesh)
    gnorm = torch.sqrt(sum(sq) + 1e-12)
    scale = torch.clamp_max(grad_clip / gnorm, 1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(g, m, v, w):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return m, v, w - lr * (u + weight_decay * w)

    out = tree_map(upd, grads, state.m, state.v, state.master)
    master = _nth(out, 2)
    new_params = tree_map(lambda w, p: w.to(p.dtype), master, params)
    return (new_params, AdamWState(step, _nth(out, 0), _nth(out, 1), master),
            gnorm)


def _nth(tree_of_tuples, i: int):
    """The ``i``-th element of each leaf's tuple in a ``tree_map`` result
    over a tree of dicts."""
    if isinstance(tree_of_tuples, dict):
        return {k: _nth(v, i) for k, v in tree_of_tuples.items()}
    return tree_of_tuples[i]


class AdafactorState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    vr: Any              # row second moment (or the full v for < 2-D leaves)
    vc: Any              # column second moment


def adafactor_init(params) -> AdafactorState:
    def rows(p):
        return _f32_zeros(p if p.dim() < 2 else p[..., 0])

    def cols(p):
        if p.dim() < 2:
            return torch.zeros((), dtype=torch.float32, device=p.device)
        return _f32_zeros(p[..., 0, :])

    return AdafactorState(step=_step0(params), vr=tree_map(rows, params),
                          vc=tree_map(cols, params))


def _split_axes(spec, dim: int, ndim: int, mesh) -> tuple:
    """The mesh axes of more than one rank that split dim ``dim`` (from
    the end) of an ``ndim``-dim leaf laid out by ``spec``."""
    i = ndim + dim
    if mesh is None or spec is None or not 0 <= i < len(spec):
        return ()
    axes = mesh.axes(sh.norm_axes(spec[i]))
    return axes if mesh.size(axes) > 1 else ()


def _global_mean(x: torch.Tensor, dim: int, axes, mesh, *,
                 keepdim: bool = False) -> torch.Tensor:
    """The mean over dim ``dim`` of the leaf ``x`` is this rank's block of,
    that dim split over ``axes``: the ranks' sums added, over the whole
    dim's length."""
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    return sh.psum(x.sum(dim=dim, keepdim=keepdim), axes, mesh=mesh) / (
        x.shape[dim] * mesh.size(axes))


def adafactor_update(grads, state: AdafactorState, params, *, lr,
                     decay=0.8, eps=1e-30, clip=1.0, specs=None, mesh=None):
    """-> (new params, new state, 0.0 in place of a grad norm). ``specs``,
    ``mesh``: the leaves split over a mesh's ranks. Each factor is the
    whole leaf's: a row or column mean over a split dim, the rows' mean
    that normalises the row factor and the update's RMS sum over the axes
    that split them, so every rank updates its block as one device
    updates the whole leaf."""
    step = state.step + 1
    beta = 1.0 - torch.pow(step.float(), -decay)
    specs = specs or {}

    def upd(path, g, vr, vc, p):
        spec = specs.get(path)
        rows, cols = (_split_axes(spec, d, p.dim(), mesh) for d in (-2, -1))
        every = mesh.axes([a for e in spec or () for a in sh.norm_axes(e)]) \
            if mesh is not None else ()
        g = g.float()
        g2 = g * g + eps
        if p.dim() < 2:
            vr = beta * vr + (1 - beta) * g2
            u = g / torch.sqrt(vr)
        else:
            vr = beta * vr + (1 - beta) * _global_mean(g2, -1, cols, mesh)
            vc = beta * vc + (1 - beta) * _global_mean(g2, -2, rows, mesh)
            r = vr / torch.clamp_min(_global_mean(vr, -1, rows, mesh,
                                                  keepdim=True), eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :])
        if every and mesh.size(every) > 1:
            ms = sh.psum(torch.sum(u * u), every, mesh=mesh) / (
                u.numel() * mesh.size(every))
        else:
            ms = torch.mean(u * u)
        rms = torch.sqrt(ms + 1e-12)
        u = u / torch.clamp_min(rms / clip, 1.0)
        return vr, vc, (p.float() - lr * u).to(p.dtype)

    out = [upd(path, g, vr, vc, p) for (path, g), vr, vc, p in zip(
        flatten_with_paths(grads), leaves(state.vr), leaves(state.vc),
        leaves(params))]
    zero = torch.zeros((), dtype=torch.float32, device=step.device)
    return (unflatten_like(params, [o[2] for o in out]),
            AdafactorState(step, unflatten_like(params, [o[0] for o in out]),
                           unflatten_like(params, [o[1] for o in out])),
            zero)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """step -> fp32 learning rate: linear warmup, then a cosine to 0."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr
