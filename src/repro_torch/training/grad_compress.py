"""Gradients with microbatch accumulation, and the int8-quantized cross-pod
mean (port of ``repro.training.grad_compress``).

On one device ``loss_and_grads`` is ``_accumulate``, as the reference's is
on a mesh without a ``pod`` axis. ``_quantized_pod_mean`` keeps the
reference's arithmetic for stacked per-pod gradients ``[npods, ...]``:

    scale = max|g| / 127                  (per tensor)
    q     = round(g / scale)    : int8
    sum   = sum over pods of int16(q)     (int16: exact for <= 256 pods)
    g     = sum * scale / n_pods

On a mesh over a ``torch.distributed`` world each rank accumulates the
gradients of its own rows' loss (every collective passes its adjoint
back; ``distributed.sharding``). Within a pod a leaf's gradient is summed
over the ranks that hold it whole (the in-pod axes its spec does not
split; one fp32 all-reduce per set of axes, leaves packed together) and
divided by the pod's ranks: the mean over the batch ranks. Across pods,
:func:`_pod_mean_int8` carries the reference's arithmetic to the wire:
the scale from one fp32 max of every leaf's max|g| over the pods and
over the leaf's blocks (one max over every axis of the mesh), the
int8 payloads of all leaves packed and all-gathered over ``pod``, and
each rank's own int16 sum of them (``_wire_sum``), the reference's exact
sum. The wire is a gather because neither gloo nor NCCL reduces int16. A
rank receives (P - 1) N bytes for N gradients over P pods, where a ring
all-reduce in int16 would take 4 (P - 1) / P N: half at the reference's 2
pods, even at 4, more beyond."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as sh

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


def _psum_packed(tensors, mesh, axes):
    """Each tensor summed over ``axes``, all in one fp32 all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = sh.psum(flat, axes, mesh=mesh)
    return list(torch.split(flat, [t.numel() for t in tensors]))


def _pod_local_mean(grads, specs: Dict[str, Any], mesh):
    """The in-pod mean: each leaf summed over the in-pod axes its spec
    leaves whole, divided by the ranks in a pod."""
    in_pod = tuple(a for a in mesh.axis_names if a != "pod")
    n = mesh.size(in_pod)
    flat = flatten_with_paths(grads)
    groups = defaultdict(list)
    for i, (path, _) in enumerate(flat):
        split = set(a for e in specs.get(path, ()) for a in sh.norm_axes(e))
        groups[tuple(a for a in in_pod if a not in split)].append(i)
    out = [g for _, g in flat]
    for axes, idx in groups.items():
        if axes:
            for i, g in zip(idx, _psum_packed([out[i] for i in idx], mesh,
                                              axes)):
                out[i] = g.view(out[i].shape)
    return unflatten_like(grads, [g / n for g in out])


def _pod_mean_int8(grads, mesh):
    """The mean over pods of every leaf, through int8 payloads gathered
    over ``pod`` and an int16 sum on each rank: ``_quantized_pod_mean`` of
    the pods' stacked gradients, leaf by leaf. A leaf's scale is its
    largest value over the pods and over every block of it, so one max
    over all of the mesh's axes (a replicated leaf's copies are equal)."""
    npods = mesh.shape["pod"]
    gs = [g.float() for g in leaves(grads)]
    amax = sh.pmax(torch.stack([g.abs().max() for g in gs]),
                   mesh.axis_names, mesh=mesh)
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.cat([torch.clamp(torch.round(g / scale[i]), -127, 127)
                   .to(torch.int8).reshape(-1) for i, g in enumerate(gs)])
    total = _wire_sum(sh.all_gather(q, "pod", 0, mesh=mesh).view(npods, -1))
    parts = torch.split(total, [g.numel() for g in gs])
    return unflatten_like(grads, [
        p.float().view(g.shape) * (scale[i] / npods)
        for i, (p, g) in enumerate(zip(parts, gs))])


def loss_and_grads(loss_fn: Callable, params, batch, *,
                   num_microbatches: int = 1, mesh=None,
                   pod_compress: bool = True,
                   param_specs: Optional[Dict[str, Any]] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, fp32 grads). One device (``mesh`` None or without a world):
    ``_accumulate``. On a mesh: this rank's rows of the batch, the loss
    averaged over the ranks and the grads by the in-pod mean, then across
    pods by :func:`_pod_mean_int8` (``pod_compress``) or an fp32 mean.
    ``param_specs`` (``{leaf path: PartitionSpec}``, the model's
    ``extras["param_specs"]``) names the leaves split over mesh axes."""
    loss, grads = _accumulate(loss_fn, params, batch, num_microbatches)
    if mesh is None or mesh.world is None:
        return loss, grads
    in_pod = tuple(a for a in mesh.axis_names if a != "pod")
    grads = _pod_local_mean(grads, param_specs or {}, mesh)
    loss = sh.pmean(loss, in_pod, mesh=mesh)
    if "pod" in mesh.shape:
        if pod_compress:
            grads = _pod_mean_int8(grads, mesh)
        else:
            flat = leaves(grads)
            grads = unflatten_like(grads, [
                g.view(f.shape) / mesh.shape["pod"] for g, f in
                zip(_psum_packed(flat, mesh, "pod"), flat)])
        loss = sh.pmean(loss, "pod", mesh=mesh)
    return loss, grads
