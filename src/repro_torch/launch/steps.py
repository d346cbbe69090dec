"""Step-function factory shared by the dry run and the card's cells (port
of ``repro.launch.steps``).

For each (arch, shape) cell this builds the function the system would
run. The reference jits it with explicit in/out shardings; here it is a
plain callable on the device's tensors, and its arguments come as meta
tensors (``arg_specs``: shapes and dtypes, no memory) that the dry run
counts on. The rules are computed and recorded as the reference computes
them.

On a mesh without a world (one device) they place nothing, so the
sharding variants (``sequence_parallel``, ``dp_major``,
``context_parallel``, ``moe_mode``, ``pod_compress``) change no
computation. On a mesh over a ``torch.distributed`` world each rank builds
its model with the rules (``build_model(mesh=, rules=)``: expert parallel
moe, context-parallel prefill, the in-pod and int8 cross-pod gradient
means), ``arg_specs`` are the rank's shapes, and ``make_args`` gives each
rank its shard of the same global arguments: its blocks of the seeded
weights and its rows of the global batch by the ``batch`` rule (pods
first, as ``loss_and_grads`` folds them; within a pod each microbatch's
rows split over the batch axes, as the reference shards each microbatch).
One code path, no divergence."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, suggest_microbatches
from repro_torch.distributed.sharding import (
    norm_axes, rank_rows, serve_rules, sharding_context, strip_pod,
    train_rules,
)
from repro_torch.launch.inputs import (
    decode_input_specs, make_concrete, prefill_batch_specs, train_batch_specs,
)
from repro_torch.models.api import Model, build_model


def rules_for(cfg: ModelConfig, kind: str, multi_pod: bool,
              moe_mode: Optional[str] = None) -> Dict[str, Any]:
    """moe_mode (serve, big MoE only):
      '2d'     — experts x model, d_ff x data; tokens gathered over data
                 (baseline; right for decode where tokens are tiny)
      'gather' — experts x model, d_model x data (FSDP-style storage);
                 expert *weights* gathered per layer (the §Perf fix for
                 prefill, where token bytes >> expert-slice bytes)."""
    if kind == "train":
        return train_rules(multi_pod)
    # MoE whose model-sharded experts exceed ~half of HBM needs a second
    # sharding dimension at serve (DESIGN.md §6)
    expert_bytes_tp = (cfg.num_layers * cfg.num_experts * 3 * cfg.d_model
                       * cfg.d_ff * 2 / 16)
    big_moe = expert_bytes_tp > 8e9
    if not big_moe:
        return serve_rules(multi_pod, shard_experts_2d=False)
    if (moe_mode or "2d") == "2d":
        return serve_rules(multi_pod, shard_experts_2d=True)
    rules = serve_rules(multi_pod, shard_experts_2d=False)
    rules["fsdp"] = "data"          # gather-weights mode
    return rules


def fit_batch_sharding(rules: Dict[str, Any], mesh, global_batch: int
                       ) -> Dict[str, Any]:
    """Drop batch-sharding axes that don't divide the global batch (e.g.
    long_500k's global_batch=1 cannot shard over 16 data shards)."""
    axes = rules.get("batch")
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else (axes or ()))
                 if a in mesh.shape)

    def fits(t):
        n = 1
        for a in t:
            n *= mesh.shape[a]
        return n and global_batch % n == 0

    while axes and not fits(axes):
        axes = axes[:-1]
    rules = dict(rules)
    rules["batch"] = axes or None
    rules["users"] = rules["batch"]
    return rules


@dataclasses.dataclass
class StepBundle:
    """A step + everything needed to count or call it."""
    fn: Any                       # callable on the model's device
    arg_specs: Tuple[Any, ...]    # meta tensors of fn's arguments
    model: Model
    rules: Dict[str, Any]
    meta: Dict[str, Any]
    # seed -> fn's arguments on the model's device: seeded weights,
    # make_concrete batches; decode: an empty cache whose lengths are full
    make_args: Callable[[int], Tuple[Any, ...]] = None


def _device(mesh) -> torch.device:
    if not mesh.devices:
        raise ValueError("this mesh has no devices (a production shape, "
                         "for the sharding rules only); build a step on "
                         "launch.mesh.make_local_mesh")
    return mesh.devices[0]


def _models(cfg: ModelConfig, mesh, rules, **opts) -> Tuple[Model, Model]:
    """(the model on the mesh's device, the same model on meta); on a
    mesh over a world, this rank's model."""
    if mesh.world is not None:
        opts.update(mesh=mesh, rules=rules)
    return (build_model(cfg, device=_device(mesh), **opts),
            build_model(cfg, device="meta", **opts))


def _params(model: Model, seed: int):
    gen = torch.Generator(device=model.device if model.device.type != "meta"
                          else "cpu")
    return model.init(gen.manual_seed(seed))


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                     optimizer: str = "adamw", remat: str = "full",
                     pod_compress: bool = True,
                     sequence_parallel: bool = False,
                     dp_major: bool = False,
                     num_microbatches: Optional[int] = None) -> StepBundle:
    """The port's training step (``training.train_loop.make_train_step``);
    one device runs the whole global batch, so the microbatch count is
    ``suggest_microbatches`` over one data shard."""
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    multi_pod = "pod" in mesh.shape
    rules = fit_batch_sharding(rules_for(cfg, "train", multi_pod), mesh,
                               shape.global_batch)
    if sequence_parallel:
        rules["seq"] = "model"
    if dp_major:
        nshards = mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
        fsdp_axes = (("data", "model") if cfg.d_model % nshards == 0
                     else ("data",))   # divisibility fallback (e.g. d=960)
        rules.update(batch=("pod", "data", "model") if multi_pod
                     else ("data", "model"),
                     fsdp=fsdp_axes,
                     heads=None, kv_heads=None, ffn=None, vocab=None)
        rules = fit_batch_sharding(rules, mesh, shape.global_batch)
    rules_model = strip_pod(rules) if multi_pod else rules
    model, meta_model = _models(cfg, mesh, rules_model, remat=remat)
    dp = (1 if mesh.world is None
          else mesh.shape.get("data", 1) * mesh.shape.get("pod", 1))
    nmb = num_microbatches or suggest_microbatches(cfg, shape, dp)
    tc = TrainConfig(num_microbatches=nmb, optimizer=optimizer,
                     pod_compress=pod_compress)
    step, opt_init = make_train_step(model, tc)

    def train_step(params, opt_state, batch):
        with sharding_context(mesh, rules_model):
            return step(params, opt_state, batch)

    batch_specs = train_batch_specs(cfg, shape)
    params_shape = _params(meta_model, 0)

    def make_args(seed: int = 0):
        params = _params(model, seed)
        return (params, opt_init(params), rank_rows(
            make_concrete(batch_specs, vocab=cfg.vocab_size,
                          device=model.device), mesh, rules["batch"], nmb))

    return StepBundle(
        fn=train_step,
        arg_specs=(params_shape, opt_init(params_shape),
                   rank_rows(batch_specs, mesh, rules["batch"], nmb)),
        model=model, rules=rules,
        meta={"kind": "train", "num_microbatches": nmb, "optimizer": optimizer,
              "remat": remat},
        make_args=make_args,
    )


def _model_opts(cfg: ModelConfig, q_block: int, k_block: int):
    """The transformer families take prefill block sizes; the others have
    none to take."""
    if cfg.family in ("dense", "moe", "vlm"):
        return {"q_block": q_block, "k_block": k_block}
    return {}


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                       remat: str = "none", max_len: Optional[int] = None,
                       q_block: int = 512, k_block: int = 1024,
                       moe_mode: Optional[str] = "gather",
                       context_parallel: bool = False) -> StepBundle:
    multi_pod = "pod" in mesh.shape
    rules = fit_batch_sharding(
        rules_for(cfg, "serve", multi_pod, moe_mode=moe_mode), mesh,
        shape.global_batch)
    if context_parallel:
        rules["seq"] = "model"      # §Perf: context-parallel dense prefill
    model, meta_model = _models(cfg, mesh, rules, remat=remat,
                                **_model_opts(cfg, q_block, k_block))
    batch_specs = prefill_batch_specs(cfg, shape)
    Smax = max_len or _dec_len(cfg, shape)

    def serve_prefill(params, batch):
        with sharding_context(mesh, rules), torch.no_grad():
            return model.prefill(params, batch, max_len=Smax)

    def make_args(seed: int = 0):
        return (_params(model, seed), rank_rows(
            make_concrete(batch_specs, vocab=cfg.vocab_size,
                          device=model.device), mesh, rules["batch"]))

    return StepBundle(fn=serve_prefill,
                      arg_specs=(_params(meta_model, 0),
                                 rank_rows(batch_specs, mesh,
                                           rules["batch"])),
                      model=model, rules=rules,
                      meta={"kind": "prefill", "max_len": Smax},
                      make_args=make_args)


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                      remat: str = "none",
                      moe_mode: Optional[str] = None) -> StepBundle:
    """Decode updates the cache it is given in place (the reference
    donates it)."""
    multi_pod = "pod" in mesh.shape
    rules = fit_batch_sharding(
        rules_for(cfg, "serve", multi_pod, moe_mode=moe_mode), mesh,
        shape.global_batch)
    model, meta_model = _models(cfg, mesh, rules, remat=remat)
    B, S = shape.global_batch, shape.seq_len
    nb = 1
    for a in norm_axes(rules["batch"]):
        nb *= mesh.shape[a] if mesh.world is not None else 1
    B //= nb                          # this rank's slots
    cache_len = _dec_len(cfg, shape)

    def cache(m: Model):
        if cfg.is_encoder_decoder:
            return m.init_cache(B, cache_len, enc_len=S)
        return m.init_cache(B, S)

    tok_specs, len_specs = decode_input_specs(cfg, shape)

    def serve_decode(params, cache, tokens, lengths):
        with sharding_context(mesh, rules), torch.no_grad():
            return model.decode_step(params, cache, tokens, lengths)

    def make_args(seed: int = 0):
        c = cache(model)
        c["lengths"].fill_(cache_len - 1)
        tokens = rank_rows(make_concrete(
            {"tokens": tok_specs}, vocab=cfg.vocab_size,
            device=model.device), mesh, rules["batch"])["tokens"]
        return _params(model, seed), c, tokens, c["lengths"].clone()

    return StepBundle(fn=serve_decode,
                      arg_specs=(_params(meta_model, 0), cache(meta_model),
                                 *rank_rows({"t": tok_specs, "l": len_specs},
                                            mesh, rules["batch"]).values()),
                      model=model, rules=rules,
                      meta={"kind": "decode", "cache_len": S},
                      make_args=make_args)


def _dec_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if cfg.is_encoder_decoder:
        return shape.seq_len // cfg.decoder_ratio
    return shape.seq_len


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, **opts) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **opts)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, **opts)
    return build_decode_step(cfg, shape, mesh, **opts)
