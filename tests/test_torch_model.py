"""Dense model parity: the port against the JAX package on bridged weights.

Two small configurations (G = 2 and G = 3), bf16 as the reference runs
them. Prefill logits and the prefill KV cache must agree to one bf16
rounding (rtol 2**-7): the port rounds where the reference rounds, and the
two libraries only sum fp32 products in other orders. Sixteen decode steps
feed both the same tokens (teacher forcing); their logits may drift a little
further as such flips compound through the layers, so they are held to two
bf16 roundings of the largest logit, and the greedy choice must agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CONFIGS, build_pair, configs, f32

from repro_torch.configs.registry import ARCHITECTURES as T_ARCHITECTURES
from repro.configs.registry import ARCHITECTURES

BF16_ULP = 2.0 ** -7
MAX_LEN = 48


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    return request.param, build_pair(request.param)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 11, 5], np.int32)
    return toks, lens


def _close(t, j, rtol=BF16_ULP):
    np.testing.assert_allclose(f32(t), f32(j), rtol=rtol, atol=1e-6)


def test_configs_are_copies():
    import dataclasses
    assert set(T_ARCHITECTURES) == set(ARCHITECTURES)
    for name, cfg in ARCHITECTURES.items():
        assert (dataclasses.asdict(T_ARCHITECTURES[name])
                == dataclasses.asdict(cfg))
    for name in CONFIGS:
        jc, tc = configs(name)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.padded(1) == type(tc.padded(1))(**dataclasses.asdict(
            jc.padded(1)))


def test_bridge_is_bit_exact(pair):
    _, (jm, jp, tm, tp) = pair
    flat_j = jax.tree.leaves(jp)
    flat_t = jax.tree.leaves(tp)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(
            np.asarray(a).view(np.uint16), b.view(torch.int16).numpy()
            .view(np.uint16))


def test_seeded_init_shapes_match_reference(pair):
    _, (jm, jp, tm, tp) = pair
    p0 = tm.init(torch.Generator().manual_seed(0))
    p1 = tm.init(torch.Generator().manual_seed(0))
    for a, b, ref in zip(jax.tree.leaves(p0), jax.tree.leaves(p1),
                         jax.tree.leaves(jp)):
        assert tuple(a.shape) == ref.shape and a.dtype == torch.bfloat16
        assert torch.equal(a, b)


def _prefill_both(jm, jp, tm, tp, toks, lens):
    jl, jc = jax.jit(lambda p, t, l: jm.prefill(
        p, {"tokens": t, "lengths": l}, max_len=MAX_LEN))(jp, toks, lens)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)},
                        max_len=MAX_LEN)
    return jl, jc, tl, tc


def test_prefill_logits_and_cache(pair):
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    _close(tl, jl)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


def test_decode_logits_16_steps(pair):
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    toks, lens = _prompts(cfg)
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    step = jax.jit(jm.decode_step)
    jlen = jnp.asarray(lens)
    tlen = torch.from_numpy(lens.copy())
    rng = np.random.default_rng(7)
    for _ in range(16):
        nxt = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt), jlen)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tlen)
        scale = np.abs(f32(jl)).max()
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=0,
                                   atol=2 * BF16_ULP * scale)
        np.testing.assert_array_equal(f32(tl).argmax(-1), f32(jl).argmax(-1))
        jlen, tlen = jlen + 1, tlen + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(f32(tc[key]), f32(jc[key]), rtol=0,
                                   atol=4 * BF16_ULP)


def test_padded_prefill_matches_exact(pair):
    """A prompt padded up a ladder rung gives the logits and cache rows of
    the same prompt prefilled at its exact length, in the port as in the
    reference."""
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=11).astype(np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = prompt
    tl_pad, tc_pad = tm.prefill(tp, {"tokens": torch.from_numpy(padded),
                                     "lengths": torch.tensor([11],
                                                             dtype=torch.int32)},
                                max_len=MAX_LEN)
    tl_ex, tc_ex = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[None])},
                              max_len=MAX_LEN)
    _close(tl_pad, tl_ex)
    for key in ("k", "v"):
        _close(tc_pad[key][:, :, :11], tc_ex[key][:, :, :11])
    jl_ex, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                          max_len=MAX_LEN)
    _close(tl_ex, jl_ex)


def test_bridge_defaults_to_the_card(monkeypatch):
    """The bridge is an entry point: without a card its default device
    raises (no fallback); ``device="cpu"`` keeps bf16 bits and fp32
    arrays as they are."""
    from repro_torch.bridge import params_from_numpy, tensor_from_numpy

    tree = {"w": np.asarray(jnp.asarray([[1.5, -2.25]], jnp.bfloat16)),
            "g": {"b": np.arange(3, dtype=np.float32)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="cuda"):
        tensor_from_numpy(tree["g"]["b"])
    with pytest.raises(ValueError):
        params_from_numpy(tree, device="meta")
    out = params_from_numpy(tree, device="cpu")
    assert out["w"].device.type == "cpu" and out["w"].dtype == torch.bfloat16
    assert out["w"].float().tolist() == [[1.5, -2.25]]
    assert out["g"]["b"].dtype == torch.float32
    assert out["g"]["b"].tolist() == [0.0, 1.0, 2.0]
