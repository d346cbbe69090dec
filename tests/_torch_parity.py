"""Shared builders for the JAX-vs-port parity tests (tests/test_torch_*.py).

Both packages get the same weights: the JAX model is initialised from a
PRNG key, its parameters go to numpy and through ``repro_torch.bridge`` into
the port. Inputs are made with numpy from a seed and handed to both."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs.registry import ARCHITECTURES, reduced_config
from repro.distributed.sharding import serve_rules
from repro.launch.mesh import compat_make_mesh
from repro.models.api import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHITECTURES as T_ARCHITECTURES
from repro_torch.configs.registry import reduced_config as t_reduced_config
from repro_torch.models.api import build_model as torch_build_model

# the two small dense configurations: smollm reduced as the JAX tests reduce
# it (G = 2), and a variant with G = 3 like the full-width model (15 / 5)
G3 = dict(num_heads=6, num_kv_heads=2, d_model=96, head_dim=16, d_ff=288)
CONFIGS = ("g2", "g3")
# reduced xlstm-125m (1 pair, d_model 64, 4 heads, hd 32), built with
# chunk 8 (prompts span several chunks) and with the default chunk 256
XLSTM_CONFIGS = ("x8", "x256")
# reduced hymba-1.5b (d_model 64, 4 / 2 heads of 16, window 16, ssm_state
# 8): h2 as the JAX tests reduce it (2 layers, globals (0,): segments [1]),
# chunk 256; h5, 5 layers with globals (0, 2, 4), segments [1, 1, 0] like
# the full model's [14, 15, 0], built with chunk 8 so that prompts span
# several chunks of the scan
HYMBA_CONFIGS = ("h2", "h5")
H5 = dict(num_layers=5, global_layers=(0, 2, 4))
# the encdec, vlm and moe families, each reduced as the JAX tests reduce it
# (G = 2) and narrow with its real grouping: seamless-m4t-medium ("ed2";
# "ed1", 4 / 4 heads, MHA like the full model's 16 / 16), internvl2-1b
# ("vl2"; "vl7", 7 / 1 heads of 16 like the full model's 14 / 2) and
# dbrx-132b ("mo2"; "mo6", 6 / 1 heads of 32 like the full model's 48 / 8;
# 4 experts, top-2, as reduced)
FAMILY_CONFIGS = {
    "ed2": ("seamless-m4t-medium", {}),
    "ed1": ("seamless-m4t-medium", dict(num_heads=4, num_kv_heads=4)),
    "vl2": ("internvl2-1b", {}),
    "vl7": ("internvl2-1b", dict(num_heads=7, num_kv_heads=1, head_dim=16)),
    "mo2": ("dbrx-132b", {}),
    "mo6": ("dbrx-132b", dict(num_heads=6, num_kv_heads=1, head_dim=32)),
}


def configs(name: str):
    """(JAX config, port config) with identical fields."""
    if name in XLSTM_CONFIGS:
        return (reduced_config(ARCHITECTURES["xlstm-125m"]),
                t_reduced_config(T_ARCHITECTURES["xlstm-125m"]))
    if name in FAMILY_CONFIGS:
        arch, narrow = FAMILY_CONFIGS[name]
        return tuple(dataclasses.replace(red(arch_cfgs[arch]), **narrow)
                     for red, arch_cfgs in ((reduced_config, ARCHITECTURES),
                                            (t_reduced_config,
                                             T_ARCHITECTURES)))
    if name in HYMBA_CONFIGS:
        jc = reduced_config(ARCHITECTURES["hymba-1.5b"])
        tc = t_reduced_config(T_ARCHITECTURES["hymba-1.5b"])
        if name == "h5":
            jc, tc = (dataclasses.replace(c, **H5) for c in (jc, tc))
        return jc, tc
    jc = reduced_config(ARCHITECTURES["smollm-360m"])
    tc = t_reduced_config(T_ARCHITECTURES["smollm-360m"])
    if name == "g3":
        jc = dataclasses.replace(jc, **G3)
        tc = dataclasses.replace(tc, **G3)
    return jc, tc


def mesh_rules():
    return compat_make_mesh((1, 1), ("data", "model")), serve_rules(False)


def build_pair(name: str, seed: int = 0, **fields):
    """JAX model + params and the port's model + bridged params (CPU);
    ``fields`` replace config fields in both."""
    jc, tc = (dataclasses.replace(c, **fields) for c in configs(name))
    opts = {"chunk": int(name[1:])} if name in XLSTM_CONFIGS else {}
    if name == "h5":
        opts = {"chunk": 8}
    mesh, rules = mesh_rules()
    jm = jax_build_model(jc, mesh, rules, **opts)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = torch_build_model(tc, device="cpu", **opts)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def f32(x) -> np.ndarray:
    """JAX array or torch tensor (any float dtype) -> fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def t_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def family_batch(cfg, rng, toks, lengths=None, *, frames=8, scale=0.5):
    """The same prefill batch for both packages: ``toks`` [B, S] int32,
    optional ``lengths`` [B]; encdec adds seeded fp32 ``frames`` [B,
    frames, d] and vlm ``prefix_embeddings`` [B, num_prefix_embeddings, d]
    (``frames`` == 0: none), each N(0, scale**2). Returns (JAX batch,
    torch batch)."""
    arrays = {"tokens": np.asarray(toks, np.int32)}
    if lengths is not None:
        arrays["lengths"] = np.asarray(lengths, np.int32)
    B = arrays["tokens"].shape[0]
    if cfg.family == "encdec":
        arrays["frames"] = (rng.normal(size=(B, frames, cfg.d_model))
                            * scale).astype(np.float32)
    if cfg.family == "vlm" and frames:
        arrays["prefix_embeddings"] = (rng.normal(size=(
            B, cfg.num_prefix_embeddings, cfg.d_model)) * scale).astype(
            np.float32)
    jb = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    return jb, tb


def bridged(tree):
    """A reference cache (or any tree of arrays) as torch tensors on the
    CPU, bit for bit."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
