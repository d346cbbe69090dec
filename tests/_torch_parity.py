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


def configs(name: str):
    """(JAX config, port config) with identical fields."""
    if name in XLSTM_CONFIGS:
        return (reduced_config(ARCHITECTURES["xlstm-125m"]),
                t_reduced_config(T_ARCHITECTURES["xlstm-125m"]))
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


def build_pair(name: str, seed: int = 0):
    """JAX model + params and the port's model + bridged params (CPU)."""
    jc, tc = configs(name)
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


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 2.0 ** -133


def record_logits(monkeypatch, srv, engine_module, to_numpy, sync):
    """Record, per request, the logits row each of its tokens was sampled
    from: wraps the engine module's ``sample`` and the server's ``_admit``
    and ``_decode_once``. A prefill's row i belongs to the i-th admitted
    slot in slot order, a decode step's row s to the request in slot s."""
    calls, per_req = [], {}
    sample = engine_module.sample

    def recording_sample(logits, key, **kw):
        to_numpy(logits, calls)
        return sample(logits, key, **kw)

    monkeypatch.setattr(engine_module, "sample", recording_sample)
    admit, decode = srv._admit, srv._decode_once

    def recording_admit(params):
        before, n = set(srv._active), len(calls)
        admit(params)
        sync()
        if len(calls) > n:
            new = sorted(s for s in srv._active if s not in before)
            for i, s in enumerate(new):
                per_req.setdefault(srv._active[s].request_id, []).append(
                    calls[-1][i])

    def recording_decode(params):
        slots = {s: r.request_id for s, r in srv._active.items()}
        n = len(calls)
        decode(params)
        sync()
        if len(calls) > n:
            for s, rid in slots.items():
                per_req[rid].append(calls[-1][s])

    monkeypatch.setattr(srv, "_admit", recording_admit)
    monkeypatch.setattr(srv, "_decode_once", recording_decode)
    return per_req


def assert_streams_within_ties(streams, logits):
    """``streams``: (JAX, port) dicts of request id -> greedy tokens;
    ``logits``: the rows each token was sampled from (``record_logits``).
    Each port stream equals JAX's up to the first step whose two best JAX
    logits lie within one bf16 ulp: there a one-ulp difference from the
    libraries' fp32 summation orders may pick the other token (ROADMAP.md
    §C). A divergence anywhere else fails."""
    for rid, jt in streams[0].items():
        tt = streams[1][rid]
        assert [int(np.argmax(row)) for row in logits[0][rid]] == jt
        assert [int(np.argmax(row)) for row in logits[1][rid]] == tt
        k = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b), None)
        if k is None:
            continue
        row = logits[0][rid][k]
        a, b = jt[k], tt[k]
        gap = float(row[a] - row[b])
        assert gap <= bf16_ulp(max(abs(row[a]), abs(row[b]))), (
            f"request {rid} diverges at token {k}: JAX picks {a} "
            f"(logit {row[a]}), the port {b} (JAX logit {row[b]}): not a "
            f"bf16 near-tie")
