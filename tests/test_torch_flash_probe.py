"""The planted-key inputs that hold prefill flash attention to its plain
version at long prompts (``repro_torch.kernels.flash_attention.probe``), on
the CPU: on N(0, 1) inputs a lost output passes the kernel check's tolerance
past a few thousand keys; on planted inputs every loaded key tile moves its
rows' outputs by several tolerances, so each fault ``probe.faults`` models
fails that check; ``probe.without`` with nothing lost is the plain version;
and the plain version agrees with the reference's jnp prefill attention on
planted inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro_torch.kernels.flash_attention import probe
from repro_torch.kernels.flash_attention.flash_attention import (
    INSTANCES, geometry, key_tiles)
from repro_torch.kernels.flash_attention.ops import flash_attention_op

from _torch_parity import f32

BF16_ULP = 2.0 ** -7
# the kernel check's tolerance (chip_smoke.py TOL, tests/test_torch_cuda.py)
RTOL, ATOL = BF16_ULP, 3 * BF16_ULP


def _fails(got, want):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() > ATOL + RTOL * w.abs()).any())


def test_random_inputs_cannot_see_a_lost_tile_at_long_prompts():
    """Why the long cases plant keys: on N(0, 1) inputs the last 64 rows of
    an 8,192-key prompt (through q_offset) are mostly smaller than the
    check's absolute tolerance, so an output of zeros passes on most
    elements and a lost key tile, first, middle, last or diagonal, passes
    the check; on planted inputs each of them fails it."""
    B, Sq, Sk, Hq, Hkv, D = 1, 64, 8192, 3, 1, 64
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=gen).bfloat16()
               for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    want = flash_attention_op(q, k, v, q_offset=Sk - Sq)
    beyond = want.float().abs() > ATOL / (1 - RTOL)
    assert beyond.float().mean() < 0.25
    seen = list(probe.faults(q, k, v, want, q_offset=Sk - Sq))
    assert len(seen) == 5
    for name, bad in seen[1:]:
        assert not _fails(bad, want), name
    q, k, v = probe.planted(gen, B, Sq, Sk, Hq, Hkv, D, "cpu")
    want = flash_attention_op(q, k, v, q_offset=Sk - Sq)
    for name, bad in probe.faults(q, k, v, want, q_offset=Sk - Sq):
        assert _fails(bad, want), name


# (B, Sq, Sk, Hq, Hkv, D, q_offset, window, causal, kv_valid): causal from
# row 0 and through an offset, a binding window, a kv_valid that ends
# mid-tile, non-causal, G 1 to 13, D 16 to 128
PROBE_CASES = [
    (1, 512, 512, 6, 2, 64, None, 0, True, None),
    (1, 96, 1024, 15, 5, 64, 928, 0, True, None),
    (2, 640, 640, 4, 1, 64, None, 300, True, None),
    (2, 700, 700, 6, 2, 32, None, 0, True, [700, 650]),
    (1, 64, 900, 13, 1, 16, None, 0, False, None),
    (1, 200, 1024, 12, 2, 128, 824, 0, True, None),
    (1, 512, 512, 4, 4, 64, None, 0, True, None),
    # a binding window whose last M tile's diagonal tile holds no planted
    # key: the fault is then emulated on an earlier M tile
    (1, 2000, 2000, 3, 1, 64, None, 1000, True, None),
]


@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("case", PROBE_CASES)
def test_planted_keys_make_every_lost_tile_fail_the_check(case, instance):
    B, Sq, Sk, Hq, Hkv, D, q_off, window, causal, lens = case
    gen = torch.Generator().manual_seed(31)
    q, k, v = probe.planted(gen, B, Sq, Sk, Hq, Hkv, D, "cpu")
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    kw = dict(causal=causal, window=window, q_offset=q_off, kv_valid=kv)
    want = flash_attention_op(q, k, v, **kw, q_block=Sq, k_block=Sk)
    assert torch.isfinite(want.float()).all()
    names = []
    for name, bad in probe.faults(q, k, v, want, instance=instance, **kw):
        assert _fails(bad, want), name
        names.append(name)
    assert len(names) == 5, names
    # each row's output is the mean of its planted keys' V rows: a column
    # reads PLANT x (its keys) / (the row's planted keys)
    off = Sk - Sq if q_off is None else q_off
    kvv = Sk if lens is None else lens[0]
    w = window if window > 0 else 1 << 30
    for r in (0, Sq // 2, Sq - 1):
        pos = off + r
        keys = [j for j in range(0, Sk, probe.STRIDE)
                if j < kvv and j > pos - w and (j <= pos or not causal)]
        if not keys:
            continue
        fed = torch.zeros(D)
        for j in keys:
            fed[(j // probe.STRIDE) % D] += probe.PLANT / len(keys)
        for h in range(Hq):
            assert torch.allclose(want[0, r, h].float(), fed, rtol=RTOL,
                                  atol=ATOL), (r, h)


@pytest.mark.parametrize("instance", INSTANCES)
def test_every_full_key_tile_holds_a_planted_key(instance):
    """The planted keys' stride is at most the narrowest key tile, so each
    full tile the geometry loads holds one, wherever its range starts."""
    for D in (16, 32, 64, 128):
        geo = geometry(1, 300, 3000, 6, 2, D, True, instance)
        assert probe.STRIDE <= geo.k_tile
        for tile in range(geo.m_tiles):
            for t0, _ in key_tiles(geo, tile, 300, 3, 3000, 3000,
                                   q_offset=2700, window=777, causal=True):
                assert any(j % probe.STRIDE == 0
                           for j in range(t0, t0 + geo.k_tile))


@pytest.mark.parametrize("window", [0, 40])
def test_without_nothing_lost_is_the_plain_version(window):
    B, Sq, Sk, Hq, Hkv, D = 2, 48, 300, 6, 2, 32
    gen = torch.Generator().manual_seed(2)
    q, k, v = probe.planted(gen, B, Sq, Sk, Hq, Hkv, D, "cpu")
    kv = torch.tensor([300, 211], dtype=torch.int32)
    want = flash_attention_op(q, k, v, window=window, kv_valid=kv)
    rows = torch.arange(Sq)
    for b in range(B):
        for kh in range(Hkv):
            got = probe.without(q, k, v, b=b, kh=kh, rows=rows,
                                q_offset=Sk - Sq, window=window, causal=True,
                                kv_valid=kv, lost=(0, 0))
            assert torch.equal(got, want[b, :, kh * 3:(kh + 1) * 3])


@pytest.mark.parametrize("case", [PROBE_CASES[1], PROBE_CASES[3],
                                  PROBE_CASES[4]])
def test_plain_version_matches_jax_on_planted_keys(case):
    """The port's prefill attention (its plain version on the CPU) against
    the reference's jnp prefill attention on planted inputs, to one bf16
    rounding."""
    B, Sq, Sk, Hq, Hkv, D, q_off, window, causal, lens = case
    gen = torch.Generator().manual_seed(31)
    q, k, v = probe.planted(gen, B, Sq, Sk, Hq, Hkv, D, "cpu")
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = flash_attention_op(q, k, v, causal=causal, window=window,
                             q_offset=q_off, kv_valid=kv, q_block=Sq,
                             k_block=Sk)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref = JC.attention_prefill(
        j(q), j(k), j(v), causal=causal, window=window, q_block=Sq,
        k_block=Sk,
        q_offset=q_off,
        kv_valid=None if lens is None else jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(f32(out), f32(ref), rtol=BF16_ULP, atol=1e-6)
