"""The plain float32 references against the program's own plain CPU path
at a tiny size, both in float32 on the same weights: hymba's exact prefill
past the window and its padded ladder prefill, then decode through the
ring and the SSD state; the moe model's prefill and decode, dropless.
Also: the weights tree the benchmark makes is the one the program's
``init`` makes."""

import numpy as np
import pytest
import torch

import _tiny
from bench import harness, weights
from bench.reference import hymba as RH
from bench.reference import moe as RM
from bench.reference.common import Precision, fp32_mode

ATOL = RTOL = 2e-3      # two float32 orders of the same sums


def _port(conf, dtype=torch.float32):
    from repro_torch.models.api import build_model
    return build_model(harness.model_config(conf), device="cpu",
                       dtype=dtype)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("family,conf", [("hybrid", _tiny.HYMBA),
                                         ("moe", _tiny.MOE)])
def test_weights_tree_is_the_programs(family, conf):
    model = _port(conf, torch.bfloat16)
    theirs = _flat(model.init(torch.Generator().manual_seed(0)))
    ours = _flat(weights.make_params(family, conf, 0, "cpu"))
    assert theirs == ours


def _serve(model, params, toks, lengths, steps, max_len):
    """Prefill ``toks`` [B, S] (``lengths``: padded), then ``steps`` greedy
    decode steps; each row's logits from its last prompt position on."""
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32)}
    B = batch["tokens"].shape[0]
    if lengths is not None:
        batch["lengths"] = torch.as_tensor(lengths, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, max_len=max_len)
        lens = cache["lengths"].clone()
        rows = [[logits[b]] for b in range(B)]
        for _ in range(steps):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits, cache = model.decode_step(params, cache, tok, lens)
            lens = lens + 1
            for b in range(B):
                rows[b].append(logits[b])
    return [torch.stack(r) for r in rows]


def _check(ref, conf, params, toks, lens, rows):
    seqs, firsts = [], []
    for b, r in enumerate(rows):
        n = lens[b]
        served = r.argmax(-1)
        seqs.append(torch.cat([torch.as_tensor(toks[b][:n], dtype=torch.long),
                               served[:-1]]))
        firsts.append(n - 1)
    with fp32_mode():
        want = ref.logits_of(params, conf, seqs, firsts, Precision("fp32"))
    for got, exp in zip(rows, want):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_hymba_exact_prefill_past_the_window_then_decode():
    conf = dict(_tiny.HYMBA, window=16)
    model = _port(conf)
    params = weights.make_params("hybrid", conf, 3, "cpu", torch.float32)
    toks = np.random.default_rng(0).integers(0, 300, size=(1, 40))
    rows = _serve(model, params, toks, None, 12, 64)
    _check(RH, conf, params, toks, [40], rows)


def test_hymba_padded_ladder_prefill_then_decode_through_the_ring():
    conf = dict(_tiny.HYMBA, window=16)
    model = _port(conf)
    params = weights.make_params("hybrid", conf, 4, "cpu", torch.float32)
    toks = np.random.default_rng(1).integers(0, 300, size=(2, 16))
    rows = _serve(model, params, toks, [9, 16], 20, 64)
    _check(RH, conf, params, toks, [9, 16], rows)


def test_moe_prefill_then_decode_dropless():
    model = _port(_tiny.MOE)
    params = weights.make_params("moe", _tiny.MOE, 5, "cpu", torch.float32)
    toks = np.random.default_rng(2).integers(0, 300, size=(2, 12))
    rows = _serve(model, params, toks, None, 10, 40)
    _check(RM, _tiny.MOE, params, toks, [12, 12], rows)


def test_fp8_control_rounds_and_fp32_does_not():
    x = torch.randn(64, 32)
    assert torch.equal(Precision("fp32").act(x), x)
    y = Precision("fp8").act(x)
    rel = ((y - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 0 < rel < 2 ** -3
