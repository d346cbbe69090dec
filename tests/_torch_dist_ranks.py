"""The port's side of ``test_torch_distributed.py``: programs that each rank
of a gloo world on the CPU runs (``repro_torch.launch.mesh.run_ranks``),
and the tree format both sides share. Imports no JAX: the ranks are
spawned processes that load the reference's params and outputs from
``.npz`` files the reference's subprocess wrote."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the reference's cases (tests/test_perf_variants.py), cut as it cuts them
CP_CASE = dict(arch="granite-8b", tokens=(2, 64), block=16)
DP_CASE = dict(arch="dbrx-132b", batch=(8, 32), capacity=8.0)
EP2D_CASE = dict(arch="kimi-k2-1t-a32b", tokens=(2, 32), capacity=8.0)
POD_CASE = dict(arch="granite-8b", shape=("t", 32, 8, "train"),
                microbatches=2)
SERVE_CASE = dict(arch="dbrx-132b", capacity=8.0, slots=4, max_len=48,
                  requests=6, new_tokens=8, seed=0)


def config(arch: str, capacity=None):
    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    cfg = reduced_config(ARCHITECTURES[arch], num_layers=2, d_model=64)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    return cfg


def load_tree(path):
    """A nested dict of numpy arrays from ``save_tree``'s ``.npz`` (bf16
    leaves as ``ml_dtypes.bfloat16``, restored from their 16-bit
    patterns)."""
    import ml_dtypes
    out = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            if key.endswith("::bf16"):
                key, a = key[:-6], a.view(ml_dtypes.bfloat16)
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a
    return out


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _rows(tree, mesh, rules, nmb=1):
    from repro_torch.distributed.sharding import rank_rows
    return rank_rows({k: torch.from_numpy(np.asarray(v))
                      for k, v in tree.items()}, mesh, rules["batch"], nmb)


def _global_grads(grads, specs, mesh):
    """{path: fp32 numpy} of the global gradients (split leaves gathered)."""
    from repro_torch.distributed.sharding import gather_global
    from repro_torch.tree import flatten_with_paths
    return {p: _f32(gather_global(g, specs[p], mesh) if p in specs else g)
            for p, g in flatten_with_paths(grads)}


def full_logits(model, logits):
    """Logits over the whole vocab: a rank's block of them gathered over
    the axes that split the vocab (``extras["vocab_axes"]``)."""
    from repro_torch.distributed.sharding import all_gather
    axes = model.extras.get("vocab_axes")
    if not axes:
        return logits
    return all_gather(logits, axes, logits.dim() - 1,
                      mesh=model.extras["mesh"])


def world_8(rank: int, refdir: str):
    """Every case of the (2, 4) and (2, 2, 2) meshes, on one world of 8."""
    from repro_torch.bridge import params_for_rank
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import serve_rules, train_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.training.grad_compress import (
        _accumulate, _pod_local_mean, loss_and_grads)

    out = {}
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    w = mesh.world
    out["mesh24"] = {"coords": w.coords, "members": w.members}
    ref = dict(np.load(f"{refdir}/outputs.npz"))

    # context-parallel prefill against the replicated one, on the mesh
    cfg = config(CP_CASE["arch"])
    rules = serve_rules(False)
    rules_cp = dict(rules, seq="model")
    blk = dict(q_block=CP_CASE["block"], k_block=CP_CASE["block"])
    tree = load_tree(f"{refdir}/cp_params.npz")
    toks = _rows({"tokens": ref["cp_tokens"]}, mesh, rules)
    for name, r in (("cp", rules_cp), ("tp", rules)):
        m = build_model(cfg, device="cpu", mesh=mesh, rules=r, **blk)
        w.record.clear()
        with torch.no_grad():
            logits, cache = m.prefill(params_for_rank(tree, m), toks)
        out[f"{name}_logits"] = _f32(full_logits(m, logits))
        out[f"{name}_cache"] = {k: _f32(cache[k]) for k in ("k", "v")}
        out[f"{name}_record"] = w.record.summary()
    # one decode step on the TP layout's cache (this rank's kv head)
    with torch.no_grad():
        local = params_for_rank(tree, m)
        _, cache = m.prefill(local, toks, max_len=toks["tokens"].shape[1] + 1)
        tok = _rows({"t": ref["cp_tokens"][:, :1]}, mesh, rules)["t"]
        logits, cache = m.decode_step(local, cache, tok,
                                      cache["lengths"].clone())
    out["tp_decode_logits"] = _f32(full_logits(m, logits))
    out["tp_decode_cache"] = {k: _f32(cache[k]) for k in ("k", "v")}

    # dp-major training and the baseline rules: the loss and gradients
    cfg = config(DP_CASE["arch"], DP_CASE["capacity"])
    tree = load_tree(f"{refdir}/dp_params.npz")
    batch = {"tokens": ref["dp_tokens"], "labels": ref["dp_labels"]}
    base = train_rules(False)
    dpm = dict(base, batch=("data", "model"), fsdp=("data",), heads=None,
               kv_heads=None, ffn=None, vocab=None)
    for name, r in (("base", base), ("dpm", dpm)):
        m = build_model(cfg, device="cpu", mesh=mesh, rules=r)
        specs = m.extras["param_specs"]
        w.record.clear()
        loss, grads = loss_and_grads(m.loss_fn, params_for_rank(tree, m),
                                     _rows(batch, mesh, r), mesh=mesh,
                                     param_specs=specs)
        out[f"{name}_loss"] = float(loss)
        out[f"{name}_record"] = w.record.summary()
        out[f"{name}_grads"] = _global_grads(grads, specs, mesh)
        out[f"{name}_specs"] = {p: tuple(s) for p, s in specs.items()}

    # moe gather mode against ep2d (kimi)
    cfg = config(EP2D_CASE["arch"], EP2D_CASE["capacity"])
    tree = load_tree(f"{refdir}/ep2d_params.npz")
    r2d = serve_rules(False, shard_experts_2d=True)
    rg = dict(serve_rules(False), fsdp="data")
    toks = _rows({"tokens": ref["ep2d_tokens"]}, mesh, r2d)
    for name, r in (("ep2d", r2d), ("gather", rg)):
        m = build_model(cfg, device="cpu", mesh=mesh, rules=r)
        with torch.no_grad():
            out[f"{name}_logits"] = _f32(full_logits(m, m.prefill(
                params_for_rank(tree, m), toks)[0]))
        out[f"{name}_specs"] = {p: tuple(s) for p, s in
                                m.extras["param_specs"].items()}

    # the multi-pod step with the int8 pod wire, on (2, 2, 2)
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    w3 = mesh3.world
    out["mesh222"] = {"coords": w3.coords, "members": w3.members}
    cfg = config(POD_CASE["arch"])
    nmb = POD_CASE["microbatches"]
    bundle = build_train_step(cfg, ShapeSpec(*POD_CASE["shape"]), mesh3,
                              num_microbatches=nmb)
    m = bundle.model
    params = params_for_rank(load_tree(f"{refdir}/pod_params.npz"), m)
    batch = _rows({"tokens": ref["pod_tokens"], "labels": ref["pod_labels"]},
                  mesh3, bundle.rules, nmb)
    w3.record.clear()
    loss, grads = loss_and_grads(m.loss_fn, params, batch,
                                 num_microbatches=nmb, mesh=mesh3,
                                 param_specs=m.extras["param_specs"])
    out["pod_record"] = w3.record.summary()
    out["pod_specs"] = {p: tuple(s) for p, s in
                        m.extras["param_specs"].items()}
    out["pod_loss"] = float(loss)
    out["pod_grads"] = _global_grads(grads, m.extras["param_specs"], mesh3)
    # and the step the launcher runs, on the same arguments
    _, opt, _ = bundle.make_args(0)
    _, _, metrics = bundle.fn(params, opt, batch)
    out["pod_step_loss"] = float(metrics["loss"])
    # the pod's own mean, before the pod wire (pods 0 and 1: ranks 0, 4)
    _, g = _accumulate(m.loss_fn, params, batch, nmb)
    out["pod_local"] = _global_grads(
        _pod_local_mean(g, m.extras["param_specs"], mesh3),
        m.extras["param_specs"], mesh3)
    if rank:                                   # rank 0 carries the arrays
        for k in ("dpm_grads", "pod_grads"):
            out.pop(k)
    if rank not in (0, 4):
        out.pop("pod_local")
    return out


def serve_requests(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(5, 13)))
            .astype(np.int32) for _ in range(n)]


def serve(model, params, cfg, device="cpu"):
    """SERVE_CASE's requests through a greedy ``LMServer`` in calibrated
    simulation -> (streams by request id, engine report)."""
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.serving.engine import LMServer

    c = SERVE_CASE
    srv = LMServer(model, device=device, slots=c["slots"],
                   max_len=c["max_len"], temperature=0.0,
                   clock=VirtualClock(),
                   service_model=lambda kind, b, t: 0.001 * b + 1e-5 * t)
    rids = [srv.submit(p, max_new_tokens=c["new_tokens"])
            for p in serve_requests(cfg, c["requests"], c["seed"])]
    srv.run(params)
    return ({r: srv.completed[r].tokens for r in rids}, srv.engine_report(),
            srv)


def serve_config(arch: str):
    """SERVE_CASE's config of ``arch`` (its capacity for a moe)."""
    return config(arch, SERVE_CASE["capacity"] if arch == SERVE_CASE["arch"]
                  else None)


def world_serve(rank: int, shape=(1, 4), arch=SERVE_CASE["arch"]):
    """``LMServer`` on a (data, model) mesh, the seeded weights of the
    one-device model: dbrx reduced (``ep`` with one expert a rank on (1,
    4)) or a dense model, its attention, FFN, embedding and head split
    over ``model``, and over ``data`` each data row its slots."""
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model

    mesh = make_local_mesh(*shape, device="cpu")
    cfg = serve_config(arch)
    model = build_model(cfg, device="cpu", mesh=mesh, rules=serve_rules(False))
    params = model.init(torch.Generator().manual_seed(SERVE_CASE["seed"]))
    streams, report, srv = serve(model, params, cfg)
    out = {"streams": streams, "report": report,
           "record": mesh.world.record.summary(),
           "cache": tuple(srv.cache["k"].shape),
           "wq": tuple(params["layers"]["attn"]["wq"].shape)}
    if cfg.family == "moe":
        out["experts"] = tuple(params["layers"]["moe"]["wi"].shape)
    return out


def launcher_serve(rank: int, model_parallelism: int, argv):
    """``launch.serve``'s ``main`` on this rank, in a world already
    joined, on ``make_elastic_mesh(model_parallelism)`` -> its mesh, slots
    and streams."""
    import functools
    from repro_torch.launch import mesh as M, serve as S

    S.init_world_from_env = lambda device: True
    S.make_elastic_mesh = functools.partial(M.make_elastic_mesh,
                                            model_parallelism)
    srv = S.main(argv)
    return {"mesh": dict(srv.mesh.shape), "slots": srv.slots,
            "streams": {r: q.tokens for r, q in srv.completed.items()}}


ADAFACTOR_LR = 1e-2


def adafactor_case(arch: str):
    """(config, seeded one-device-model params seed, batch) of the
    Adafactor parity worlds: a reduced config (dbrx at capacity 8), a
    (4, 32) batch from ``default_rng(0)``."""
    cfg = config(arch, 8.0 if arch == "dbrx-132b" else None)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    return cfg, batch


def world_adafactor(rank: int, shape, arch: str):
    """Adafactor on a (data, model) mesh under ``train_rules``: dense TP
    (and ``fsdp`` over data), the moe experts over ``model``. (a) The
    optimizer alone, on the one device's fp32 params and gradients cut to
    this rank's blocks; (b) one training step. -> the global updated
    params of each."""
    from repro_torch.bridge import params_for_rank
    from repro_torch.distributed.sharding import rank_rows, train_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.grad_compress import loss_and_grads
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import tree_map

    mesh = make_local_mesh(*shape, device="cpu")
    cfg, batch = adafactor_case(arch)
    rules = train_rules(False)
    model = build_model(cfg, device="cpu", mesh=mesh, rules=rules)
    specs = model.extras["param_specs"]
    one = build_model(cfg.padded_config(shape[1]), device="cpu")
    whole = one.init(torch.Generator().manual_seed(0))
    _, grads = loss_and_grads(one.loss_fn, whole, batch)
    p32 = tree_map(lambda t: t.float(), params_for_rank(whole, model))
    new, _, _ = opt.adafactor_update(
        params_for_rank(grads, model), opt.adafactor_init(p32), p32,
        lr=ADAFACTOR_LR, specs=specs, mesh=mesh)
    out = {"opt": _global_grads(new, specs, mesh)}
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer="adafactor", lr=ADAFACTOR_LR, warmup_steps=0,
        total_steps=10))
    params = model.init(torch.Generator().manual_seed(0))
    new, _, metrics = step(params, opt_init(params),
                           rank_rows(batch, mesh, rules["batch"]))
    out["step"] = _global_grads(new, specs, mesh)
    out["loss"] = float(metrics["loss"])
    out["record"] = mesh.world.record.summary()
    return out


def card_ep_rank(rank: int, params, tokens):
    """On a card shared by 4 gloo ranks: dbrx reduced (``SERVE_CASE``'s
    config), ``ep`` over (1, 4), prefill and 4 greedy decode steps from
    the one-device weights (CUDA handles) -> (logits per step, the
    decode attention kernel's launches)."""
    from repro_torch.bridge import params_for_rank
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serving.sampler import sample

    mesh = make_local_mesh(1, 4, device="cuda", share=True)
    cfg = config(SERVE_CASE["arch"], SERVE_CASE["capacity"])
    model = build_model(cfg, mesh=mesh, rules=serve_rules(False))
    local = params_for_rank(params, model)
    return _prefill_and_decode(model, local, tokens, decode_attention_op,
                               sample)


def _prefill_and_decode(model, params, tokens, op, sample, steps=4):
    out = []
    with torch.no_grad():
        before = op.launches
        logits, pc = model.prefill(params, {"tokens": tokens},
                                   max_len=tokens.shape[1] + steps + 1)
        logits = full_logits(model, logits)
        lengths = pc["lengths"].clone()
        for _ in range(steps):
            out.append(logits.float().cpu().numpy())
            tok = sample(logits, None, temperature=0.0)[:, None]
            logits, pc = model.decode_step(params, pc, tok, lengths)
            logits = full_logits(model, logits)
            lengths = lengths + 1
        out.append(logits.float().cpu().numpy())
        return out, op.launches - before


# the real ranks against the counting ranks (test_torch_rank_count.py):
# both meshes in one world, the families reduced, a serve and a train step
COUNT_MESHES = {"data x model": ((2, 2), ("data", "model")),
                "pod x data x model": ((2, 1, 2), ("pod", "data", "model"))}
COUNT_ARCHS = ("smollm-360m", "dbrx-132b", "hymba-1.5b",
               "seamless-m4t-medium", "xlstm-125m")
COUNT_STEPS = {"serve": ("decode", 64, 4), "train": ("train", 64, 4)}


def world_counts(rank: int):
    """On each mesh of ``COUNT_MESHES``, each family's serve (decode) and
    ``train_rules`` step (``pod_compress`` on, the default) counted twice:
    run on this rank's real world, and on a counting rank at the same
    coordinates -> {(mesh, arch, step): (real counts, counting rank's)},
    each ``hlo_stats.HloStats.to_dict()``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import make_mesh, make_rank_mesh
    from repro_torch.launch.steps import build_step

    out = {}
    for name, (shape, axes) in COUNT_MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        counting = make_rank_mesh(shape, axes, mesh.world.coords)
        for arch in COUNT_ARCHS:
            cfg = config(arch)
            for step, (kind, seq, batch) in COUNT_STEPS.items():
                spec = ShapeSpec(step, seq, batch, kind)
                real = build_step(cfg, spec, mesh)
                got = hlo_stats.count(real.fn, *real.make_args(0),
                                      mesh=mesh)
                meta = build_step(cfg, spec, counting)
                want = hlo_stats.count(meta.fn, *meta.arg_specs,
                                       mesh=counting)
                out[(name, arch, step)] = (got.to_dict(), want.to_dict())
    return out
