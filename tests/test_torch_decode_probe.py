"""The planted-key inputs that hold decode attention's split and merge to the
plain version at long caches (``repro_torch.kernels.decode_attention.probe``),
on the CPU: on N(0, 1) inputs a lost output passes the kernel check's
tolerance at a long cache; on planted inputs every slice of the split moves
the output by several tolerances, so each fault ``probe.faults`` models
fails that check; ``probe.without`` with nothing dropped is the plain
version; and the plain version agrees with the reference's jnp decode
attention on planted inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro_torch.kernels.decode_attention import probe
from repro_torch.kernels.decode_attention.decode_attention import (
    MAX_CLUSTER, MAX_SPLITS, split_slices, splits)
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

from _torch_parity import f32

BF16_ULP = 2.0 ** -7
# the kernel check's tolerance (chip_smoke.py TOL, tests/test_torch_cuda.py)
RTOL, ATOL = BF16_ULP, 3 * BF16_ULP


def _fails(got, want):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() > ATOL + RTOL * w.abs()).any())


# (B, Hq, Hkv, D, Smax, window, lengths, p): one block, clusters, the
# workspace split up to MAX_SPLITS (one tile a slice at 16,384 / 256), G 1
# to 16, the 128-wide and the narrow instances, a window, lengths 0, 1, Smax
PROBE_CASES = [
    (2, 15, 5, 64, 256, 0, [256, 100], 1),
    (8, 15, 5, 64, 256, 32, [0, 1, 37, 128, 200, 255, 256, 64], 2),
    (3, 25, 5, 64, 4096, 0, [0, 1, 4096], 8),
    (2, 13, 1, 64, 8192, 0, [8192, 3000], 9),
    (1, 16, 1, 128, 16384, 0, [16384], MAX_SPLITS),
    (2, 6, 2, 20, 9000, 0, [9000, 7], 53),
    (2, 15, 5, 64, 12000, 5000, [12000, 6000], 27),
    (1, 8, 1, 100, 16384, 0, [16000], 128),
]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_planted_keys_make_every_slice_fail_the_check_when_lost(case):
    B, Hq, Hkv, D, Smax, window, lengths, p = case
    gen = torch.Generator().manual_seed(31)
    q, k, v, ln = probe.planted(gen, B, Hq, Hkv, D, Smax, window, lengths,
                                p, "cpu")
    want = decode_attention_ref(q, k, v, ln, window=window)
    assert torch.isfinite(want.float()).all()
    # each sample's planted keys: the first and last position of each
    # nonempty slice; every head puts nearly all its weight on them, so
    # each column they feed reads PLANT x (its keys) / (all planted keys)
    for b, n in enumerate(lengths):
        ends = sorted({e for s0, s1 in split_slices(n, Smax, window, p)
                       if s1 > s0 for e in (s0, s1 - 1)})
        out = want[b, 0].float()
        if not ends:
            assert not out.any()
            continue
        fed = torch.zeros(D)
        for i in range(len(ends)):
            fed[i % D] += probe.PLANT / len(ends)
        assert len(ends) <= 2 * MAX_SPLITS
        assert (fed[fed > 0] >= probe.PLANT / (2 * MAX_SPLITS)).all()
        for h in range(Hq):
            assert torch.allclose(out[h], fed, rtol=RTOL, atol=ATOL), (b, h)
    names = []
    for name, bad in probe.faults(q, k, v, ln, window, p):
        assert _fails(bad, want), name
        names.append(name)
    assert len(names) >= (6 if p > 1 else 5)
    # and the plain version passes it
    assert not _fails(decode_attention_op(q, k, v, ln, window=window), want)


def test_random_inputs_cannot_see_a_lost_output_at_long_caches():
    """Why the long cases plant keys: on N(0, 1) q, K and V over 65,536
    positions the output is smaller than the check's absolute tolerance,
    so an output of zeros passes; on planted inputs it fails."""
    B, Hq, Hkv, D, Smax = 1, 5, 1, 64, 65536
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=gen).bfloat16()
               for s in ((B, 1, Hq, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D)))
    ln = torch.tensor([Smax], dtype=torch.int32)
    want = decode_attention_ref(q, k, v, ln)
    assert not _fails(torch.zeros_like(want), want)
    p = splits(B, Hkv, D, Smax, 0)
    assert p > MAX_CLUSTER
    q, k, v, ln = probe.planted(gen, B, Hq, Hkv, D, Smax, 0, [Smax], p,
                                "cpu")
    want = decode_attention_ref(q, k, v, ln)
    assert _fails(torch.zeros_like(want), want)


@pytest.mark.parametrize("window", [0, 40])
def test_without_nothing_dropped_is_the_plain_version(window):
    B, Hq, Hkv, D, Smax = 3, 6, 2, 32, 300
    gen = torch.Generator().manual_seed(2)
    q, k, v, ln = probe.planted(gen, B, Hq, Hkv, D, Smax, window,
                                [300, 0, 77], 4, "cpu")
    drop = torch.zeros((B, Hkv, Smax), dtype=torch.bool)
    assert torch.equal(probe.without(q, k, v, ln, window, drop),
                       decode_attention_ref(q, k, v, ln, window=window))


@pytest.mark.parametrize("case", [PROBE_CASES[1], PROBE_CASES[3],
                                  PROBE_CASES[5]])
def test_plain_version_matches_jax_on_planted_keys(case):
    """The port's decode attention (its plain version on the CPU) against
    the reference's jnp decode attention on planted inputs, to one bf16
    rounding."""
    B, Hq, Hkv, D, Smax, window, lengths, p = case
    gen = torch.Generator().manual_seed(31)
    q, k, v, ln = probe.planted(gen, B, Hq, Hkv, D, Smax, window, lengths,
                                p, "cpu")
    out = decode_attention_op(q, k, v, ln, window=window)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref = JC.attention_decode(j(q), j(k), j(v), jnp.asarray(lengths,
                                                             jnp.int32),
                              window=window)
    np.testing.assert_allclose(f32(out), f32(ref), rtol=BF16_ULP, atol=1e-6)
