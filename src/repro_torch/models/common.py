"""Shared model substrate: parameter specs and seeded init, norms, RoPE,
attention, projections, embedding and head.

Port of ``repro.models.common``. Tensors keep the JAX package's layouts
(activations ``[B, S, H, D]``, weights ``[in, out]``, layers stacked on a
leading ``[L]`` axis) and round to the working dtype at the same points, so
the same weights give the same tokens. The serving paths' three kernel
functions route to ``repro_torch.kernels``: on CPU tensors the plain
versions run, on CUDA tensors the Hopper kernels.

The training forward (``train=True``, as the reference's own ``train``
flags pick ``attention_train``) runs no kernel on either device: the
reference's ``loss_fn`` reaches no Pallas kernel, and a kernel's output
would have no ``grad_fn``. It takes the plain RMSNorm, the plain chunked
scan and :func:`attention_train`; :func:`with_remat` wraps a layer in
activation checkpointing.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import softmax_scale
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    """Declarative parameter: shape, init kind, dtype (``None``: the
    model's working dtype), where a mesh may shard it its logical axes
    (``None``: replicated on every rank; the reference's names), and how a
    ``normal`` leaf is drawn: ``"leaf"``, the whole leaf from the model's
    generator, or ``"matrix"`` (the experts), each matrix from a seed of
    its own (:func:`_draw_by_matrix`). ``parts`` (per dim, ``None``: 1
    each) says a dim is that many equal pieces a mesh splits each on its
    own (``sharding.PartitionSpec``)."""

    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    fan_in: Optional[int] = None
    dtype: Optional[torch.dtype] = None
    axes: Optional[Tuple[Optional[str], ...]] = None
    draw: str = "leaf"        # leaf | matrix
    parts: Optional[Tuple[int, ...]] = None


def _init_leaf(gen: torch.Generator, spec: Spec, device, dtype,
               block: Optional[Tuple[slice, ...]] = None):
    """One leaf; ``block`` (a slice a dim) keeps only that block of it."""
    dtype = spec.dtype or dtype
    block = block or tuple(slice(0, n) for n in spec.shape)
    shape = tuple(sh.block_extent(s) for s in block)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                          else spec.shape[-1])
    scale = 1.0 / math.sqrt(max(1, fan))
    if spec.draw == "matrix":
        return _draw_by_matrix(gen, spec.shape, block, scale, device, dtype)
    if shape != tuple(spec.shape) and torch.device(device).type == "cpu":
        return _draw_in_order(gen, spec.shape, block, scale, dtype)
    x = torch.randn(spec.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (x * scale)[block].to(dtype)


def _draw_in_order(gen: torch.Generator, shape, block, scale: float,
                   dtype) -> torch.Tensor:
    """This rank's block of ``torch.randn(shape, generator=gen)`` on the
    CPU, drawn one matrix (the last two dims) at a time, so a rank holds
    at most one fp32 matrix of a leaf it keeps a block of. The CPU fills a
    float tensor of n >= 16 values from n uniforms in groups of 16, its
    last 16 values from 16 more where 16 does not divide n, so draws of
    consecutive pieces give the whole draw's values wherever every piece
    but the last is a multiple of 16 long and the last at least 16. Where
    that fails the whole leaf is drawn. The card's generator places its
    values by the whole leaf's size, so a rank there draws the whole leaf
    (one at a time) and keeps its block."""
    m = int(np.prod(shape[-2:]))
    lead = tuple(shape[:-2])
    if len(shape) < 2 or (m % 16 and int(np.prod(lead)) > 1) or m < 16:
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (x * scale)[block].to(dtype)
    out = torch.empty(tuple(sh.block_extent(s) for s in block), dtype=dtype)
    keep = [range(s.start, s.stop) for s in block[:-2]]
    for idx in itertools.product(*(range(n) for n in lead)):
        x = torch.randn(shape[-2:], generator=gen, dtype=torch.float32)
        if all(i in r for i, r in zip(idx, keep)):
            at = tuple(i - s.start for i, s in zip(idx, block))
            out[at] = (x[block[-2:]] * scale).to(dtype)
    return out


def _draw_by_matrix(gen: torch.Generator, shape, block, scale: float,
                    device, dtype) -> torch.Tensor:
    """A leaf of ``draw="matrix"`` (the experts), drawn one matrix (its
    last two dims) at a time, each from a seed of its own: one draw
    of ``gen`` plus the matrix's index. A rank draws only the matrices its
    ``block`` meets and keeps their block, so its leaf is that block of
    the one-device draw and it holds no more than one fp32 matrix beyond
    its own share."""
    base = int(torch.randint(2 ** 31, (1,), generator=gen,
                             device=gen.device))
    out = torch.empty(tuple(s.stop - s.start for s in block), dtype=dtype,
                      device=device)
    if out.device.type == "meta":
        return out
    sub = torch.Generator(device=out.device)
    lead = [range(s.start, s.stop) for s in block[:-2]]
    for j, idx in enumerate(itertools.product(*lead)):
        seed = base + (int(np.ravel_multi_index(idx, shape[:-2])) if idx
                       else 0)
        m = torch.randn(shape[-2:], generator=sub.manual_seed(seed),
                        device=out.device, dtype=torch.float32)
        out[np.unravel_index(j, out.shape[:-2])] = \
            (m[block[-2:]] * scale).to(dtype)
    return out


def init_tree(gen: torch.Generator, specs, device, dtype,
              blocks: Optional[Dict[str, Tuple[slice, ...]]] = None,
              prefix: str = ""):
    """Instantiate a nested dict of Specs, drawing from ``gen`` in sorted key
    order (the order ``jax.tree.flatten`` visits the reference's tree).
    ``blocks`` (``{leaf path: slices}``, a rank's on a mesh) draws only
    those blocks of the leaves it names."""
    if isinstance(specs, Spec):
        return _init_leaf(gen, specs, device, dtype,
                          (blocks or {}).get(prefix))
    return {k: init_tree(gen, specs[k], device, dtype, blocks,
                         f"{prefix}/{k}" if prefix else k)
            for k in sorted(specs)}


def unstack(tree, n: int) -> List[Dict[str, Any]]:
    """Stacked ``[L, ...]`` leaves -> one dict of views per layer."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    per_key = {k: unstack(v, n) for k, v in tree.items()}
    return [{k: per_key[k][i] for k in per_key} for i in range(n)]


def stacked(specs, num: int):
    """Prepend a layer dimension to every Spec in the tree."""
    if isinstance(specs, Spec):
        return Spec((num,) + specs.shape, specs.init, specs.fan_in,
                    specs.dtype,
                    None if specs.axes is None else (None,) + specs.axes,
                    specs.draw,
                    None if specs.parts is None else (1,) + specs.parts)
    return {k: stacked(v, num) for k, v in specs.items()}


def sharded_leaves(specs, prefix: str = "") -> Dict[str, Spec]:
    """``{leaf path: Spec}`` of the Specs that carry axes (paths as
    ``repro_torch.tree.flatten_with_paths`` writes them)."""
    if isinstance(specs, Spec):
        return {} if specs.axes is None else {prefix: specs}
    out: Dict[str, Spec] = {}
    for k in sorted(specs):
        out.update(sharded_leaves(specs[k], f"{prefix}/{k}" if prefix
                                  else k))
    return out


def attn_specs(d_model: int, nq: int, nkv: int, hd: int,
               bias: bool) -> Dict[str, Spec]:
    s = {
        "wq": Spec((d_model, nq * hd), fan_in=d_model,
                   axes=("fsdp", "heads")),
        "wk": Spec((d_model, nkv * hd), fan_in=d_model,
                   axes=("fsdp", "kv_heads")),
        "wv": Spec((d_model, nkv * hd), fan_in=d_model,
                   axes=("fsdp", "kv_heads")),
        "wo": Spec((nq * hd, d_model), fan_in=nq * hd,
                   axes=("heads", "fsdp")),
    }
    if bias:
        s["bq"] = Spec((nq * hd,), "zeros", axes=("heads",))
        s["bk"] = Spec((nkv * hd,), "zeros", axes=("kv_heads",))
        s["bv"] = Spec((nkv * hd,), "zeros", axes=("kv_heads",))
    return s


def glu_specs(d_model: int, d_ff: int) -> Dict[str, Spec]:
    return {
        "wi": Spec((d_model, d_ff), fan_in=d_model, axes=("fsdp", "ffn")),
        "wg": Spec((d_model, d_ff), fan_in=d_model, axes=("fsdp", "ffn")),
        "wo": Spec((d_ff, d_model), fan_in=d_ff, axes=("ffn", "fsdp")),
    }


def embed_specs(vocab: int, d_model: int) -> Dict[str, Spec]:
    return {
        "embedding": Spec((vocab, d_model), fan_in=1,
                          axes=("vocab", "fsdp")),
        "head": Spec((d_model, vocab), fan_in=d_model,
                     axes=("fsdp", "vocab")),
        "final_norm": Spec((d_model,), "ones"),
    }


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------

class Placement:
    """Where a model's tensors live on a mesh, for every family: the rules
    (``serve_rules`` when none are given), the batch axes the mesh has,
    whether prefill is context parallel, each sharded leaf's
    :class:`PartitionSpec` and this rank's block of it, which dims of the
    dense leaves each layer gathers before use (their ``fsdp`` dim; under
    context parallelism every split dim, as the reference gathers its
    weights per layer there), and the mesh axes that split the heads, kv
    heads, ``d_ff`` and vocab of what the layers then compute with. A
    leaf's ``Spec.parts`` travel in its spec, so its block and its gathers
    keep each piece whole."""

    def __init__(self, mesh, rules, specs):
        self.mesh = mesh
        self.rules = dict(rules if rules is not None
                          else sh.serve_rules("pod" in (mesh.shape
                                                        if mesh else {})))
        self.batch_axes = tuple(a for a in sh.norm_axes(self.rules.get(
            "batch")) if mesh is not None and a in mesh.shape)
        self.cp = mesh is not None and self.rules.get("seq") == "model"
        self.param_specs, self.blocks, self.gathers = {}, {}, {}
        self.split = dict.fromkeys(("heads", "kv_heads", "ffn", "vocab"), ())
        if mesh is None:
            return
        ctx = sh.ShardingContext(mesh, self.rules)
        for path, leaf in sharded_leaves(specs).items():
            spec = ctx.spec(leaf.axes)
            if not spec:
                continue
            if leaf.parts is not None:
                spec = sh.PartitionSpec(spec, parts=leaf.parts[:len(spec)])
            self.param_specs[path] = spec
            self.blocks[path] = sh.block_slices(leaf.shape, spec, mesh)
            if "/moe/" in path:        # the experts gather their own
                continue
            # axes of one rank move nothing: one device's ops run there
            dims = tuple(tuple(a for a in sh.norm_axes(spec[i])
                               if mesh.shape[a] > 1) if i < len(spec) else ()
                         for i in range(len(leaf.shape)))
            gather = tuple(ax if self.cp or name == "fsdp" else ()
                           for ax, name in zip(dims, leaf.axes))
            if any(gather):
                self.gathers[path] = gather
            for ax, g, name in zip(dims, gather, leaf.axes):
                if name in self.split and ax and not g:
                    self.split[name] = ax

    def size(self, axes) -> int:
        return self.mesh.size(axes) if axes else 1

    def gathered(self, tree, prefix: str, layer: bool = False):
        """``tree`` (the leaves under ``prefix``; ``layer``: one layer's
        views of the stacked leaves) with each dense leaf gathered over the
        axes ``gathers`` names for it: whole along those dims."""
        if not self.gathers:
            return tree
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            if isinstance(v, dict):
                out[k] = self.gathered(v, path, layer)
                continue
            skip = 1 if layer else 0
            spec = self.param_specs.get(path)
            for i, axes in enumerate(self.gathers.get(path, ())[skip:]):
                if axes:
                    v = sh.gather_dim(v, axes, i, parts=spec.part(i + skip),
                                      mesh=self.mesh)
            out[k] = v
        return out

    def extras(self):
        if self.mesh is None:
            return {}
        return {"mesh": self.mesh, "rules": self.rules,
                "param_specs": self.param_specs,
                "vocab_axes": self.split["vocab"]}


# ---------------------------------------------------------------------------
# norms & rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
            train: bool = False) -> torch.Tensor:
    """The kernel's wrapper; the plain version where ``train``."""
    return (rmsnorm_ref if train else rmsnorm_op)(x, weight, eps=eps)


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5, *, train: bool = False):
    """``(x + y, rmsnorm(x + y))``, the norm reading the sum before it is
    rounded to the working dtype. The reference writes ``x = x + y`` and
    ``rmsnorm(x)``; compiled, its residual add and the norm's upcast fuse so
    the norm sees the unrounded sum, and this reproduces that."""
    return (rmsnorm_ref if train else rmsnorm_op)(x, weight, eps=eps,
                                                  residual=y)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos / sin tables of the rotary embedding for ``positions`` (any
    shape ``[..., S]``) -> two ``[..., S, 1, head_dim // 2]`` fp32 tensors.
    Computed once per forward and shared by every layer's q and k."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=positions.device) / half)
    angles = positions[..., None].float() * freqs            # [..., S, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding, split-half form, in fp32 then cast back (the
    reference's ``rope(x, positions, theta)`` with its tables from
    :func:`rope_tables`). x: [..., S, H, D]."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_train(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Full masked GQA attention in plain differentiable ops, the
    reference's ``attention_train``: q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D]. q is
    scaled in its dtype (the scale rounded to it first), the scores are
    summed in fp32 from the exact products, masked with -1e30 (``window``
    0 = full), softmaxed in fp32, and the probabilities rounded to v's dtype
    before the second product."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D) * softmax_scale(scale, D, q.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    w = window if window > 0 else 1 << 30
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = k_pos > q_pos - w
    if causal:
        mask &= k_pos <= q_pos
    s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, D)


def attention_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                      q_block: int = 512, k_block: int = 1024,
                      scale: Optional[float] = None, q_offset=None,
                      kv_valid=None) -> torch.Tensor:
    """Causal / windowed GQA prefill attention; q [B,Sq,Hq,D], k/v
    [B,Sk,Hkv,D]; ``kv_valid`` [B] masks right-pad keys, ``q_offset`` is the
    absolute position of q row 0 (default ``Sk - Sq``)."""
    return flash_attention_op(q, k, v, causal=causal, window=window,
                              q_block=q_block, k_block=k_block, scale=scale,
                              q_offset=q_offset, kv_valid=kv_valid)


def attention_decode(q, k_cache, v_cache, lengths, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a cache. q [B,1,Hq,D]; k/v_cache
    [B,Smax,Hkv,D]; lengths [B] valid positions (current token at
    lengths-1); rows with ``lengths == 0`` are 0."""
    return decode_attention_op(q, k_cache, v_cache, lengths, window=window,
                               scale=scale)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def attn_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, nq: int, nkv: int,
             hd: int):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.view(B, S, nq, hd), k.view(B, S, nkv, hd),
            v.view(B, S, nkv, hd))


def silu(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` spelled out as the reference lowers it, ``z * (1 /
    (1 + exp(-z)))``, each op rounding to the working dtype."""
    return z * torch.reciprocal(1 + torch.exp(-z))


def glu_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, axes=(), *,
              mesh=None) -> torch.Tensor:
    """The GLU FFN; where ``axes`` split ``d_ff``, ``wi``/``wg`` hold this
    rank's columns and ``wo`` its rows (:func:`row_parallel`)."""
    h = silu(x @ p["wg"]) * (x @ p["wi"])
    return row_parallel(h, p["wo"], axes, mesh=mesh)


def row_parallel(x: torch.Tensor, w: torch.Tensor, axes, *,
                 mesh) -> torch.Tensor:
    """``x @ w`` where ``x``'s last dim and ``w``'s rows are split over the
    mesh ``axes`` (the attention output over heads, the GLU's down
    projection over ``d_ff``): each rank's partial product in fp32, summed
    over ``axes`` in fp32 and rounded to the working dtype once, as one
    device rounds the whole product once. Chosen against the reference's
    own TP run (granite-8b reduced on (2, 4), ``tests/
    test_torch_distributed.py``): these logits equal its bit for bit, and
    the one device's; bf16 partials summed in bf16 (tp + 1 roundings)
    landed 1.04 bf16 roundings of the largest logit from both."""
    if not axes:
        return x @ w
    return sh.psum(x.float() @ w.float(), axes, mesh=mesh).to(x.dtype)


def embed_tokens(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 axes=(), *, mesh=None) -> torch.Tensor:
    """The embedding rows of ``tokens``. Where ``axes`` split the vocab,
    each rank looks up the tokens in its block and zeroes the rest, and the
    ranks' rows are summed over ``axes``: one value and exact zeros, so
    the sum is the lookup itself."""
    emb = p["embedding"]
    if not axes:
        return F.embedding(tokens, emb)
    n = emb.shape[0]
    local = tokens.long() - sh.axis_index(axes, mesh=mesh) * n
    inside = ((local >= 0) & (local < n))[..., None]
    x = F.embedding(local.clamp(0, n - 1), emb)
    return sh.psum(torch.where(inside, x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device)),
                   axes, mesh=mesh)


def lm_head(p: Dict[str, torch.Tensor], x: torch.Tensor,
            norm_eps: float) -> torch.Tensor:
    """Logits over the vocab columns ``head`` holds: this rank's block of
    them where a mesh splits the vocab."""
    return rmsnorm(x, p["final_norm"], norm_eps) @ p["head"]


def _lse_and_gold(logits: torch.Tensor, labels: torch.Tensor, axes, mesh):
    """(logsumexp over the vocab, the gold logit) of fp32 ``logits``
    ``[..., V]``, or of this rank's vocab block of them where ``axes``
    split it: the ranks' largest value (``pmax``, held constant), the
    shifted exp-sums summed over ``axes``, and the gold logit from the rank
    that holds it (a masked sum)."""
    if not axes:
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return torch.logsumexp(logits, -1), gold
    n = logits.shape[-1]
    top = sh.pmax(logits.detach().amax(-1), axes, mesh=mesh)
    total = sh.psum(torch.exp(logits - top[..., None]).sum(-1), axes,
                    mesh=mesh)
    local = labels.long() - sh.axis_index(axes, mesh=mesh) * n
    inside = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = sh.psum(torch.where(inside, gold, torch.zeros_like(gold)), axes,
                   mesh=mesh)
    return top + torch.log(total), gold


def chunked_loss(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 labels: torch.Tensor, norm_eps: float,
                 chunk: int = 512, axes=(), *, mesh=None) -> torch.Tensor:
    """Mean cross-entropy over the vocab, chunked over the sequence: the
    final RMSNorm (plain), then per chunk of ``min(chunk, S)`` positions
    the fp32 logsumexp minus the gold logit, summed in fp32 and divided by
    ``B * S``. The forward makes one chunk's ``[B, chunk, V]`` logits at a
    time; autograd keeps each chunk's for the backward, as the reference's
    scan keeps its residuals. x: [B,S,d]; labels: [B,S]. Where ``axes``
    split the vocab, ``head`` holds this rank's columns and the logsumexp
    and gold logit are taken over the ranks (:func:`_lse_and_gold`)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_loss: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    x = rmsnorm_ref(x, p["final_norm"], eps=norm_eps)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):
        logits = (x[:, lo:lo + chunk] @ p["head"]).float()
        lse, gold = _lse_and_gold(logits, labels[:, lo:lo + chunk], axes,
                                  mesh)
        total = total + torch.sum(lse - gold)
    return total / (B * S)


# ---------------------------------------------------------------------------
# activation checkpointing (the reference's ``jax.checkpoint`` policies)
# ---------------------------------------------------------------------------

REMAT_MODES = ("full", "dots", "none")
# the products a ``"dots"`` checkpoint keeps (``checkpoint_dots``): every
# matrix product the layers run, einsums included, lowers to one of these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def with_remat(fn: Callable, mode: str) -> Callable:
    """``fn`` under activation checkpointing: ``"full"`` keeps only its
    inputs and recomputes the rest in the backward pass, ``"dots"`` keeps
    the matrix products' outputs too, ``"none"`` is ``fn`` itself. It
    changes what the backward pass keeps, never a value."""
    if mode == "none":
        return fn
    if mode not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}: {mode!r}")
    kw = {} if mode == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def last_valid_slice(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: [B,S,d]; lengths: [B] -> [B,1,d], row ``lengths[b]-1`` per sample
    (prompts are right-padded, so the last token is per-sample)."""
    B, S, d = x.shape
    idx = (lengths.long() - 1).clamp(0, S - 1)
    return x[torch.arange(B, device=x.device), idx][:, None]


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_update(k_cache, v_cache, k_new, v_new, lengths) -> None:
    """Write one new K/V row per sample at its own position, in place.

    k_cache/v_cache: [B,Smax,Hkv,D]; k_new/v_new: [B,1,Hkv,D]; lengths: [B]
    (position to write). Positions clamp to ``[0, Smax-1]`` as
    ``lax.dynamic_update_slice`` clamps them in the reference."""
    B, Smax = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    pos = lengths.long().clamp(0, Smax - 1)
    k_cache[rows, pos] = k_new[:, 0]
    v_cache[rows, pos] = v_new[:, 0]


def ring_cache_update(k_cache, v_cache, k_new, v_new, lengths) -> None:
    """Sliding-window ring buffer, in place: write at ``lengths % W``
    (``W = k_cache.shape[1]``). RoPE is applied at write time and attention
    does not depend on the order of its KV rows, so the ring's order does
    not matter, only the count of valid rows."""
    cache_update(k_cache, v_cache, k_new, v_new,
                 lengths % k_cache.shape[1])


def attention_decode_ring(q, k_cache, v_cache, lengths, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention against a window-sized ring cache [B,W,Hkv,D]: the
    first ``min(lengths + 1, W)`` slots are valid (all of them once the
    ring has wrapped). lengths [B]: tokens seen before this one, whose row
    was just written. The count stays on the device."""
    count = (lengths + 1).clamp_max(k_cache.shape[1])
    return attention_decode(q, k_cache, v_cache, count, window=0,
                            scale=scale)
