"""The port's kernels against the JAX package, on the CPU (their checks on
the card are in tests/test_torch_cuda.py).

On CPU tensors each ``repro_torch`` kernel wrapper runs its plain PyTorch
version, which follows the reference's jnp function step for step and
rounds where it rounds. Against that jnp function it must agree to within
one bf16 rounding (rtol 2**-7): the two libraries sum fp32 products in other
orders, which can flip a rounding. Against the Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them) the tolerance is wider,
stated per test, because those kernels round at other points (q * scale and
p stay fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_op as j_decode_op
from repro.kernels.flash_attention.ops import flash_attention_op as j_flash_op
from repro.kernels.rmsnorm.ops import rmsnorm_op as j_rmsnorm_op
from repro.models import common as JC
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op

from _torch_parity import f32, t_bf16

BF16_ULP = 2.0 ** -7          # one bf16 rounding, relative


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)
    return a, t_bf16(f32(a))


def _close_to_jnp(t, j):
    np.testing.assert_allclose(f32(t), f32(j), rtol=BF16_ULP, atol=1e-6)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 96), (3, 960)])
def test_rmsnorm_plain_matches_jax(shape):
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, shape)
    jw, tw = _bf16(rng, shape[-1:], 0.25)
    jw, tw = jw + 1, tw + 1
    before = rmsnorm_op.launches
    out = rmsnorm_op(tx, tw, eps=1e-5)
    assert rmsnorm_op.launches == before       # CPU: plain version, no launch
    _close_to_jnp(out, JC.rmsnorm(jx, jw, 1e-5))
    # the Pallas kernel keeps the same fp32 statistics: same tolerance
    _close_to_jnp(out, j_rmsnorm_op(jx, jw, eps=1e-5, interpret=True))


def test_add_rmsnorm_plain_matches_compiled_jax():
    """The fused residual form against the reference's compiled
    ``x = x + y; rmsnorm(x)``: the sum is returned rounded, the norm reads it
    unrounded."""
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng, (4, 9, 64))
    jy, ty = _bf16(rng, (4, 9, 64))
    jw, tw = _bf16(rng, (64,), 0.25)

    @jax.jit
    def ref(x, y, w):
        s = x + y
        return s, JC.rmsnorm(s, w + 1, 1e-5)

    js, jh = ref(jx, jy, jw)
    ts, th = rmsnorm_op(tx, tw + 1, eps=1e-5, residual=ty)
    np.testing.assert_array_equal(f32(ts), f32(js))   # one bf16 add: exact
    _close_to_jnp(th, jh)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # (B, Hq, Hkv, D, Smax, lengths, window)
    (4, 4, 2, 16, 32, [0, 1, 17, 32], 0),
    (4, 6, 2, 16, 24, [24, 0, 5, 13], 0),          # G = 3, Smax not 2^k
    (3, 6, 2, 32, 64, [64, 40, 0], 8),             # window > 0
    (2, 15, 5, 64, 256, [256, 100], 0),            # full-width heads
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_jax(case):
    B, Hq, Hkv, D, Smax, lengths, window = case
    rng = np.random.default_rng(2)
    jq, tq = _bf16(rng, (B, 1, Hq, D))
    jk, tk = _bf16(rng, (B, Smax, Hkv, D))
    jv, tv = _bf16(rng, (B, Smax, Hkv, D))
    jl = jnp.asarray(lengths, jnp.int32)
    tl = torch.tensor(lengths, dtype=torch.int32)
    before = decode_attention_op.launches
    out = decode_attention_op(tq, tk, tv, tl, window=window)
    assert decode_attention_op.launches == before
    assert out.shape == (B, 1, Hq, D) and out.dtype == torch.bfloat16
    _close_to_jnp(out, JC.attention_decode(jq, jk, jv, jl, window=window))
    # lengths == 0 rows are exactly 0 in both
    for b, n in enumerate(lengths):
        if n == 0:
            assert not f32(out[b]).any()
    # Pallas (interpret): q * scale and p in fp32 there, bf16 here; outputs
    # are averages of N(0,1) values, so 3 bf16 ulps of 1 absolute
    k_blk = 8 if Smax % 16 else 16
    pal = j_decode_op(jq, jk, jv, jl, window=window, k_blk=k_blk,
                      interpret=True)
    np.testing.assert_allclose(f32(out), f32(pal), atol=3 * BF16_ULP,
                               rtol=BF16_ULP)


# ---------------------------------------------------------------------------
# prefill (flash) attention
# ---------------------------------------------------------------------------

PREFILL_CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, kv_valid, window, q_offset, q_block, k_block)
    (2, 16, 16, 4, 2, 16, [16, 11], 0, None, 512, 1024),
    (3, 24, 24, 6, 2, 16, [24, 7, 0], 0, None, 512, 1024),   # kv_valid 0
    (2, 32, 32, 6, 2, 16, [32, 20], 8, None, 8, 16),         # window, blocks
    (2, 8, 32, 4, 2, 16, [32, 30], 0, 24, 512, 1024),        # q_offset
    (1, 16, 16, 4, 1, 16, None, 0, None, 4, 8),              # no kv_valid
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_flash_attention_plain_matches_attention_prefill(case):
    B, Sq, Sk, Hq, Hkv, D, kvv, window, q_off, qb, kb = case
    rng = np.random.default_rng(3)
    jq, tq = _bf16(rng, (B, Sq, Hq, D))
    jk, tk = _bf16(rng, (B, Sk, Hkv, D))
    jv, tv = _bf16(rng, (B, Sk, Hkv, D))
    jkv = None if kvv is None else jnp.asarray(kvv, jnp.int32)
    tkv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32)
    before = flash_attention_op.launches
    out = flash_attention_op(tq, tk, tv, causal=True, window=window,
                             q_block=qb, k_block=kb, q_offset=q_off,
                             kv_valid=tkv)
    assert flash_attention_op.launches == before
    ref = JC.attention_prefill(jq, jk, jv, causal=True, window=window,
                               q_block=qb, k_block=kb, q_offset=q_off,
                               kv_valid=jkv)
    _close_to_jnp(out, ref)


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 2, 0), (6, 2, 0), (4, 4, 8)])
def test_flash_attention_plain_matches_pallas(Hq, Hkv, window):
    """Without kv_valid, against the Pallas kernel in interpret mode: it
    keeps q * scale and p in fp32, so 3 bf16 ulps of 1 absolute."""
    rng = np.random.default_rng(4)
    B, S, D = 2, 32, 16
    jq, tq = _bf16(rng, (B, S, Hq, D))
    jk, tk = _bf16(rng, (B, S, Hkv, D))
    jv, tv = _bf16(rng, (B, S, Hkv, D))
    out = flash_attention_op(tq, tk, tv, causal=True, window=window)
    pal = j_flash_op(jq, jk, jv, causal=True, window=window, q_blk=16,
                     k_blk=16, interpret=True)
    np.testing.assert_allclose(f32(out), f32(pal), atol=3 * BF16_ULP,
                               rtol=BF16_ULP)


def test_wrappers_refuse_other_devices_and_bad_layouts():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError):
        rmsnorm_op(x, torch.zeros((8,), device="meta"))
    q = torch.zeros((1, 1, 2, 8), device="meta")
    kv = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        decode_attention_op(q, kv, kv, torch.zeros((1,), dtype=torch.int32,
                                                   device="meta"))
    with pytest.raises(ValueError):
        flash_attention_op(q, kv, kv)
    with pytest.raises(ValueError):                 # non-contiguous x
        rmsnorm_op(torch.zeros((8, 2)).t(), torch.zeros((8,)))
    with pytest.raises(TypeError):                  # int64 lengths
        decode_attention_op(torch.zeros((1, 1, 2, 8)), torch.zeros(
            (1, 4, 1, 8)), torch.zeros((1, 4, 1, 8)), torch.ones((1,),
                                                                 dtype=torch.long))
