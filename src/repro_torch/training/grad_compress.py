"""Gradients with microbatch accumulation, and the int8-quantized cross-pod
mean (port of ``repro.training.grad_compress``).

On one device ``loss_and_grads`` is ``_accumulate``, as the reference's is
on a mesh without a ``pod`` axis. ``_quantized_pod_mean`` keeps the
reference's wire format for stacked per-pod gradients ``[npods, ...]``:

    scale = max|g| / 127                  (per tensor)
    q     = round(g / scale)    : int8
    sum   = sum over pods of int16(q)     (int16: exact for <= 256 pods)
    g     = sum * scale / n_pods"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import (
    flatten_with_paths, leaves, tree_map, unflatten_like,
)


def _accumulate(loss_fn: Callable, params, batch, num_microbatches: int):
    """(mean loss, fp32 grads in the params' tree) over ``num_microbatches``
    equal slices of the batch's leading axis. Each microbatch's gradients
    come in the params' dtype (bf16), one ``autograd.grad`` each, and are
    added into fp32 accumulators, as the reference adds them; ``params``
    are not modified."""
    flat = [leaf.detach().requires_grad_()
            for _, leaf in flatten_with_paths(params)]
    live = unflatten_like(params, flat)
    if num_microbatches <= 1:
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), unflatten_like(params,
                                             [g.float() for g in grads])
    n = num_microbatches
    size = leaves(batch)[0].shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into {n} "
                         f"microbatches")
    b = size // n
    acc_loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat]
    for i in range(n):
        loss = loss_fn(live, tree_map(lambda x: x[i * b:(i + 1) * b], batch))
        grads = torch.autograd.grad(loss, flat)
        acc = [a + g.float() for a, g in zip(acc, grads)]
        acc_loss = acc_loss + loss.detach()
    inv = 1.0 / n
    return acc_loss * inv, unflatten_like(params, [a * inv for a in acc])


def _wire_sum(q: torch.Tensor) -> torch.Tensor:
    """int8 payloads [npods, ...] summed over pods as int16 (pinned: a
    wider sum would double the bytes on the inter-pod wire)."""
    return torch.sum(q.to(torch.int16), dim=0, dtype=torch.int16)


def _quantized_pod_mean(g: torch.Tensor) -> torch.Tensor:
    """g: [npods, ...] -> mean over pods, through an int8 payload and an
    int16 sum."""
    npods = g.shape[0]
    gf = g.float()
    scale = torch.clamp_min(gf.abs().max(), 1e-20) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return _wire_sum(q).float() * (scale / npods)


def loss_and_grads(loss_fn: Callable, params, batch, *,
                   num_microbatches: int = 1) -> Tuple[torch.Tensor, Any]:
    """(loss, fp32 grads) on one device: ``_accumulate``."""
    return _accumulate(loss_fn, params, batch, num_microbatches)
