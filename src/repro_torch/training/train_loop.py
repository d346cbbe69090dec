"""Training loop: the step factory and a fault-tolerant ``train`` (port of
``repro.training.train_loop``).

The step runs eagerly on the params' device. On one device the
reference's mesh, sharding rules and jit go away; on a mesh over a
``torch.distributed`` world (the model's, ``build_model(mesh=)``) each
rank steps on its rows of the batch, the loss is averaged over the
ranks, and ``loss_and_grads`` reduces the gradients (the in-pod mean, the
int8 cross-pod mean). The loop keeps checkpoint /
restart (the same batches replay after a restart: the data are a pure
function of the step) and NaN-step skipping, decided on the device with
``torch.where`` so that no step waits for the host but the logged ones."""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.grad_compress import loss_and_grads
from repro_torch.tree import tree_map


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    num_microbatches: int = 1
    optimizer: str = "adamw"          # adamw | adafactor
    pod_compress: bool = True         # cross-pod only: no effect without pods
    skip_nan_steps: bool = True


def make_train_step(model, tc: TrainConfig, mesh=None):
    """Returns (train_step, init_opt_state). ``train_step(params,
    opt_state, batch) -> (params, opt_state, {"loss", "gnorm", "lr"})``,
    every value a tensor on the device. ``mesh`` (default: the model's)
    over a world: ``params`` and ``batch`` are this rank's."""
    schedule = opt_lib.cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)
    mesh = mesh if mesh is not None else model.extras.get("mesh")
    specs = model.extras.get("param_specs", {})
    sharded = mesh is not None and mesh.world is not None
    split = dict(specs=specs if sharded else None,
                 mesh=mesh if sharded else None)
    if tc.optimizer == "adamw":
        opt_init, opt_update = opt_lib.adamw_init, partial(
            opt_lib.adamw_update, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip, **split)
    else:
        opt_init, opt_update = opt_lib.adafactor_init, partial(
            opt_lib.adafactor_update, **split)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model.loss_fn, params, batch,
                                     num_microbatches=tc.num_microbatches,
                                     mesh=mesh, pod_compress=tc.pod_compress,
                                     param_specs=specs)
        lr = schedule(opt_state.step)
        new_params, new_opt, gnorm = opt_update(grads, opt_state, params,
                                                lr=lr)
        if tc.skip_nan_steps:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            new_params = tree_map(lambda n, o: torch.where(ok, n, o),
                                  new_params, params)
            new_opt = tree_map(lambda n, o: torch.where(ok, n, o),
                               new_opt, opt_state)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step, opt_init


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _rank_batch(batch, device, mesh, model, tc: TrainConfig):
    """The batch on ``device``; on a mesh, this rank's rows of it."""
    batch = _to_device(batch, device)
    if mesh is None:
        return batch
    return sh.rank_rows(batch, mesh, model.extras["rules"]["batch"],
                        tc.num_microbatches)


def train(model, tc: TrainConfig, data_iter, *, num_steps: int,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 100,
          resume: bool = True, log_every: int = 10, rng_seed: int = 0,
          hooks: Optional[Dict[str, Callable]] = None,
          params=None) -> Dict[str, Any]:
    """Fault-tolerant training on ``model.device``. Weights: ``params`` (for
    example bridged from the reference) or ``model.init`` from a generator
    seeded with ``rng_seed``; a checkpoint in ``checkpoint_dir`` overrides
    both when ``resume``. ``data_iter`` yields numpy batches (global ones
    on a mesh: each rank steps on its rows, and checkpoints its shards
    under ``checkpoint_dir/rank<r>``)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer

    dev = model.device
    mesh = model.extras.get("mesh")
    if mesh is not None and mesh.world is None:
        mesh = None
    if mesh is not None and checkpoint_dir:     # each rank its own shards
        checkpoint_dir = f"{checkpoint_dir}/rank{mesh.world.rank}"
    step_fn, opt_init = make_train_step(model, tc)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(rng_seed))
    opt_state = opt_init(params)
    start_step = 0
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        params = ckpt.restore(start_step, "params", params)
        opt_state = ckpt.restore(start_step, "opt", opt_state)

    history = []
    batch = next(data_iter)
    for i in range(start_step, num_steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             _rank_batch(batch, dev, mesh,
                                                         model, tc))
        if (i + 1) % log_every == 0 or i == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            history.append(m)
            if hooks and "on_log" in hooks:
                hooks["on_log"](m)
        if ckpt and ((i + 1) % checkpoint_every == 0 or i == num_steps - 1):
            ckpt.save(i + 1, {"params": params, "opt": opt_state})
        try:
            batch = next(data_iter)
        except StopIteration:
            break
    return {"params": params, "opt_state": opt_state, "history": history}
