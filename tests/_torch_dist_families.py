"""The port's side of ``test_torch_distributed_families.py``: programs that
each rank of a gloo world on the CPU runs (``repro_torch.launch.mesh.
run_ranks``) for hymba, the encoder-decoder and xlstm. Imports no JAX: the
ranks load the reference's params and outputs from the ``.npz`` files its
subprocess wrote (``_torch_dist_ranks.load_tree``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _torch_dist_ranks import (
    SERVE_CASE, _f32, _global_grads, _rows, config, full_logits, load_tree,
    serve)

FAMILIES = ("hymba-1.5b", "seamless-m4t-medium", "xlstm-125m")
KEYS = {"hymba-1.5b": "hymba", "seamless-m4t-medium": "encdec",
        "xlstm-125m": "xlstm"}
# prefill: 4 prompts of 16 tokens (an encoder memory of 16 frames);
# training: a batch of 8 x 32 (the window of reduced hymba is 16, so its
# sliding-window layers see a sequence past it)
PREFILL = dict(batch=4, seq=16, frames=16)
TRAIN = dict(batch=8, seq=32)


def serve_config(arch: str):
    """The served configs: reduced granite-8b, and reduced hymba at hymba's
    own 25 / 5 heads of 16 (at padded(2) 26 / 2 heads: G = 13 query heads
    a kv head)."""
    cfg = config(arch)
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, num_heads=25, num_kv_heads=5,
                                  head_dim=16)
    return cfg


def inputs(arch: str, d_model: int, vocab: int):
    """(prefill batch, training batch) of ``arch`` as numpy, from
    ``default_rng(0)``: tokens (and frames for the encoder-decoder)."""
    rng = np.random.default_rng(0)
    pre = {"tokens": rng.integers(0, vocab, (PREFILL["batch"],
                                             PREFILL["seq"])).astype(np.int32)}
    train = {k: rng.integers(0, vocab, (TRAIN["batch"], TRAIN["seq"]))
             .astype(np.int32) for k in ("tokens", "labels")}
    if arch == "seamless-m4t-medium":
        pre["frames"] = (rng.normal(size=(PREFILL["batch"], PREFILL["frames"],
                                          d_model)) * 0.02).astype(np.float32)
        train["frames"] = (rng.normal(size=(TRAIN["batch"], PREFILL["frames"],
                                            d_model)) * 0.02
                           ).astype(np.float32)
    return pre, train


def world_families(rank: int, refdir: str):
    """On (data 2, model 2 x 2): each family's prefill logits under
    ``serve_rules`` and its loss and gradients under ``train_rules``, from
    the reference's params; each rank's share of every split leaf, and the
    round trip of the params through ``params_for_rank`` and
    ``gather_global``."""
    from repro_torch.bridge import params_for_rank
    from repro_torch.distributed.sharding import (
        gather_global, serve_rules, train_rules)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training.grad_compress import loss_and_grads
    from repro_torch.tree import flatten_with_paths

    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    w = mesh.world
    out = {}
    for arch in FAMILIES:
        key = KEYS[arch]
        cfg = config(arch)
        tree = load_tree(f"{refdir}/{key}_params.npz")
        pre, train = inputs(arch, cfg.d_model, cfg.vocab_size)
        for name, rules in (("serve", serve_rules(False)),
                            ("train", train_rules(False))):
            m = build_model(cfg, device="cpu", mesh=mesh, rules=rules)
            specs = m.extras["param_specs"]
            local = params_for_rank(tree, m)
            out[f"{key}_{name}_specs"] = {p: (tuple(s), s.parts)
                                          for p, s in specs.items()}
            out[f"{key}_{name}_shapes"] = {p: tuple(t.shape) for p, t in
                                           flatten_with_paths(local)}
            # the round trip: each leaf gathered is the reference's leaf
            out[f"{key}_{name}_roundtrip"] = all(
                np.array_equal(_f32(gather_global(t, specs[p], mesh)),
                               np.asarray(want, np.float32))
                for (p, t), (_, want) in zip(flatten_with_paths(local),
                                             flatten_with_paths(tree))
                if p in specs)
            w.record.clear()
            if name == "serve":
                with torch.no_grad():
                    logits, _ = m.prefill(local, _rows(pre, mesh, rules))
                out[f"{key}_logits"] = _f32(full_logits(m, logits))
                if arch == "seamless-m4t-medium":
                    out.update(_encdec_decode(m, local,
                                              _rows(pre, mesh, rules)))
            else:
                loss, grads = loss_and_grads(
                    m.loss_fn, local, _rows(train, mesh, rules), mesh=mesh,
                    param_specs=specs)
                out[f"{key}_loss"] = float(loss)
                grads = _global_grads(grads, specs, mesh)
                if rank == 0:                 # rank 0 carries the arrays
                    out[f"{key}_grads"] = grads
            out[f"{key}_{name}_record"] = w.record.summary()
    return out


DECODE_STEPS = 2


def encdec_decode(model, params, batch):
    """``DECODE_STEPS`` decode steps of the encoder-decoder from its
    prefill of ``batch``, each fed the batch's first token -> the logits
    of each step (over the whole vocab) and the shapes of the cache's
    leaves."""
    import torch
    with torch.no_grad():
        _, cache = model.prefill(params, batch, max_len=PREFILL["seq"]
                                 + DECODE_STEPS + 1)
        lengths = cache["lengths"].clone()
        steps = []
        for _ in range(DECODE_STEPS):
            logits, cache = model.decode_step(params, cache,
                                              batch["tokens"][:, :1],
                                              lengths)
            steps.append(_f32(full_logits(model, logits)))
            lengths = lengths + 1
    return steps, {k: tuple(v.shape) for k, v in cache.items()}


def _encdec_decode(model, params, batch):
    steps, shapes = encdec_decode(model, params, batch)
    return {"encdec_decode": steps, "encdec_cache": shapes}


def world_serve(rank: int, arch: str, fsdp: bool):
    """``LMServer`` on (data 2, model 2), greedy, on the seeded weights of
    the one-device model (``SERVE_CASE``'s requests): ``serve_rules``, and with ``fsdp`` the weights'
    ``d_model`` dim stored over ``data`` as well, so the data rows prefill
    together. -> streams, engine report, collectives, the layout and the
    shapes of a rank's leaves and cache."""
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.tree import flatten_with_paths

    mesh = make_local_mesh(2, 2, device="cpu")
    cfg = serve_config(arch)
    rules = dict(serve_rules(False), fsdp="data" if fsdp else None)
    model = build_model(cfg, device="cpu", mesh=mesh, rules=rules)
    params = model.init(torch.Generator().manual_seed(SERVE_CASE["seed"]))
    streams, report, srv = serve(model, params, cfg)
    return {"streams": streams, "report": report,
            "record": mesh.world.record.summary(),
            "joint": srv.layout.joint,
            "slots": (srv.layout.lo, srv.layout.per_row),
            "shapes": {p: tuple(t.shape) for p, t in
                       flatten_with_paths(params)},
            "specs": {p: tuple(s) for p, s in
                      model.extras["param_specs"].items()},
            "cache": {k: tuple(v.shape) for k, v in srv.cache.items()}}


def launcher_train(rank: int, arch: str, argv):
    """``launch.train``'s ``main`` on this rank, in a world already joined,
    on ``make_elastic_mesh(2)``: 4 ranks give (data 2, model 2) -> the
    mesh, the losses and a rank's share of the embedding."""
    import functools
    from repro_torch.launch import mesh as M, train as T

    T.init_world_from_env = lambda device: True
    T.make_elastic_mesh = functools.partial(M.make_elastic_mesh, 2)
    out = T.main(argv)
    return {"losses": [h["loss"] for h in out["history"]],
            "embedding": tuple(out["params"]["embed"]["embedding"].shape)}
