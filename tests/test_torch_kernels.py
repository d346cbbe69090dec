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
from repro.kernels.ssd_scan.ops import ssd_scan_op as j_ssd_scan_op
from repro.models import common as JC
from repro.models import linear_core as JLC
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.models import linear_core as TLC

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
    # reduced hymba's ring: W = 16 slots, counts min(len + 1, W) for
    # lengths 0, 5, 15 and 40 (wrapped)
    (4, 4, 2, 16, 16, [1, 6, 16, 16], 0),
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


NONCAUSAL_CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, kv_valid, q_block, k_block): the encoder
    # (Sq == Sk, one and several key blocks) and the decoder's
    # cross-attention over the memory (Sq != Sk), G = 1 and G = 2
    (2, 16, 16, 4, 4, 16, None, 512, 1024),
    (3, 32, 32, 4, 2, 16, None, 8, 16),
    (2, 8, 32, 4, 4, 16, None, 8, 1024),
    (3, 16, 8, 4, 2, 16, None, 16, 1024),
    (2, 24, 48, 6, 2, 32, [48, 30], 8, 16),              # kv_valid
]


@pytest.mark.parametrize("case", NONCAUSAL_CASES)
def test_flash_attention_plain_noncausal_matches_jax(case):
    """``causal=False`` against ``attention_prefill`` (one bf16 rounding)
    and, without kv_valid, the Pallas kernel in interpret mode (3 bf16
    ulps of 1 absolute, as above)."""
    B, Sq, Sk, Hq, Hkv, D, kvv, qb, kb = case
    rng = np.random.default_rng(5)
    jq, tq = _bf16(rng, (B, Sq, Hq, D))
    jk, tk = _bf16(rng, (B, Sk, Hkv, D))
    jv, tv = _bf16(rng, (B, Sk, Hkv, D))
    jkv = None if kvv is None else jnp.asarray(kvv, jnp.int32)
    tkv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32)
    out = flash_attention_op(tq, tk, tv, causal=False, q_block=qb,
                             k_block=kb, kv_valid=tkv)
    ref = JC.attention_prefill(jq, jk, jv, causal=False, q_block=qb,
                               k_block=kb, kv_valid=jkv)
    _close_to_jnp(out, ref)
    if kvv is None:
        pal = j_flash_op(jq, jk, jv, causal=False, q_blk=8, k_blk=8,
                         interpret=True)
        np.testing.assert_allclose(f32(out), f32(pal), atol=3 * BF16_ULP,
                                   rtol=BF16_ULP)


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
    """Inputs on two devices and bad layouts raise; meta tensors (shapes
    only) get empty outputs of the plain version's shapes."""
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError):                 # two devices
        rmsnorm_op(x, torch.zeros((8,)))
    assert rmsnorm_op(x, torch.zeros((8,), device="meta")).shape == (2, 8)
    q = torch.zeros((1, 1, 2, 8), device="meta")
    kv = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        decode_attention_op(q, kv, kv, torch.zeros((1,), dtype=torch.int32))
    out = decode_attention_op(q, kv, kv, torch.zeros(
        (1,), dtype=torch.int32, device="meta"))
    assert (out.device.type, out.shape) == ("meta", (1, 1, 2, 8))
    with pytest.raises(ValueError):
        flash_attention_op(q, torch.zeros((1, 4, 1, 8)), kv)
    assert flash_attention_op(q, kv, kv).shape == (1, 1, 2, 8)
    with pytest.raises(ValueError):                 # non-contiguous x
        rmsnorm_op(torch.zeros((8, 2)).t(), torch.zeros((8,)))
    with pytest.raises(TypeError):                  # int64 lengths
        decode_attention_op(torch.zeros((1, 1, 2, 8)), torch.zeros(
            (1, 4, 1, 8)), torch.zeros((1, 4, 1, 8)), torch.ones((1,),
                                                                 dtype=torch.long))


# ---------------------------------------------------------------------------
# ssd_scan (chunked linear attention)
# ---------------------------------------------------------------------------
#
# Tolerances: the plain version and the references sum the same fp32
# products in other orders, so fp32 outputs and every state agree to rtol
# 2e-5 plus 2e-6 of the output's largest magnitude (about 16 fp32 ulps of
# it: sums of up to a chunk of terms cancel near zero); bf16 outputs
# additionally to one bf16 rounding (rtol 2**-7), where those fp32 sums
# straddle a rounding boundary.

def _scan_inputs(rng, B, S, H, dk, dv, dtype, state=False):
    """The same q, k, v (``dtype``), fp32 gates and optional fp32 initial
    state as JAX arrays and torch tensors."""
    def pair(a, dt):
        j = jnp.asarray(a, dt)
        t = (t_bf16(f32(j)) if dt == jnp.bfloat16
             else torch.from_numpy(np.array(j)))
        return j, t

    out = [pair(rng.normal(size=(B, S, H, dk)), dtype),
           pair(rng.normal(size=(B, S, H, dk)), dtype),
           pair(rng.normal(size=(B, S, H, dv)), dtype),
           pair(-np.abs(rng.normal(size=(B, S, H))), jnp.float32),
           pair(-np.abs(rng.normal(size=(B, S, H))), jnp.float32)]
    if state:
        out.append(pair(rng.normal(size=(B, H, dk, dv)), jnp.float32))
    return [a for a, _ in out], [b for _, b in out]


def _close_scan(t, j, dtype):
    j = f32(j)
    np.testing.assert_allclose(
        f32(t), j, rtol=BF16_ULP if dtype == jnp.bfloat16 else 2e-5,
        atol=2e-6 * max(float(np.abs(j).max()), 1.0))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,S,dk,dv,chunk", [
    (2, 3, 64, 16, 8, 16),      # mLSTM-like (dk == dv after aug)
    (1, 4, 128, 16, 64, 32),    # SSD-like (small state dim, big head dim)
    (2, 2, 32, 8, 8, 32),       # single chunk
    (2, 4, 32, 8, 16, 8),       # reduced hymba: ssm_state 8, head_dim 16
])
def test_ssd_scan_plain_matches_pallas(B, H, S, dk, dv, chunk, dtype):
    """The sweep of tests/test_kernels.py, against the Pallas kernel in
    interpret mode (zero initial state: the kernel has none)."""
    rng = np.random.default_rng(5)
    (jq, jk, jv, jf, ji), (tq, tk, tv, tf, ti) = _scan_inputs(
        rng, B, S, H, dk, dv, dtype)
    before = ssd_scan_op.launches
    y, st = ssd_scan_op(tq, tk, tv, tf, ti, chunk=chunk)
    assert ssd_scan_op.launches == before      # CPU: plain version, no launch
    assert y.dtype == tv.dtype and st.dtype == torch.float32
    jy, jst = j_ssd_scan_op(jq, jk, jv, jf, ji, chunk=chunk, interpret=True)
    _close_scan(y, jy, dtype)
    _close_scan(st, jst, jnp.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("dv", [8, 1])
def test_ssd_scan_plain_matches_chunked_linear_attention(dtype, dv):
    """A nonzero initial state carried over four chunks, and dv = 1 (the
    mLSTM normalizer), against the jnp function the JAX model calls."""
    rng = np.random.default_rng(6)
    B, S, H, dk, chunk = 2, 32, 3, 16, 8
    (jq, jk, jv, jf, ji, js), (tq, tk, tv, tf, ti, ts) = _scan_inputs(
        rng, B, S, H, dk, dv, dtype, state=True)
    y, st = ssd_scan_op(tq, tk, tv, tf, ti, chunk=chunk, initial_state=ts)
    jy, jst = JLC.chunked_linear_attention(jq, jk, jv, jf, ji, chunk=chunk,
                                           initial_state=js)
    _close_scan(y, jy, dtype)
    _close_scan(st, jst, jnp.float32)
    # the model's entry point routes to the same op
    y2, st2 = TLC.chunked_linear_attention(tq, tk, tv, tf, ti, chunk=chunk,
                                           initial_state=ts)
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_scan_plain_matches_stepwise_recurrence(chunk):
    """Chunkwise form against the one-token decode recurrence of both
    packages (fp32), from a nonzero state; the port's step updates its state
    in place."""
    rng = np.random.default_rng(7)
    B, S, H, dk, dv = 2, 16, 3, 4, 5
    (jq, jk, jv, jf, ji, js), (tq, tk, tv, tf, ti, ts) = _scan_inputs(
        rng, B, S, H, dk, dv, jnp.float32, state=True)
    y, st = ssd_scan_op(tq, tk, tv, tf, ti, chunk=chunk,
                        initial_state=ts)
    state, jstate = ts.clone(), js
    for t in range(S):
        ys, out = TLC.linear_attention_step(state, tq[:, t], tk[:, t],
                                            tv[:, t], tf[:, t], ti[:, t])
        assert out is state
        jys, jstate = JLC.linear_attention_step(jstate, jq[:, t], jk[:, t],
                                                jv[:, t], jf[:, t], ji[:, t])
        _close_scan(ys, jys, jnp.float32)
        _close_scan(y[:, t], ys, jnp.float32)
    _close_scan(state, jstate, jnp.float32)
    _close_scan(st, state, jnp.float32)


def test_linear_attention_step_rounds_as_compiled_jax():
    """The decode state update ``f * state + i * outer`` compiles to one
    fused multiply-add, ``fma(f, state, round(i * outer))``; the port's
    ``addcmul`` rounds the same way (three separate roundings differ in
    ~27 % of the elements). The two libraries' fp32 ``exp`` differ in the
    last ulp now and then (ROADMAP.md §C), so the gates are drawn where
    both give the same ``exp(log_f)`` and ``exp(log_i)``: from there the
    new state equals the compiled reference's bit for bit."""
    rng = np.random.default_rng(10)
    B, H, dk, dv = 3, 4, 8, 16
    s0 = (rng.normal(size=(B, H, dk, dv)) * 3).astype(np.float32)
    jq, tq = _bf16(rng, (B, H, dk))
    jk, tk = _bf16(rng, (B, H, dk))
    jv, tv = _bf16(rng, (B, H, dv))

    def gates(draw):
        x = draw(size=4 * B * H).astype(np.float32)
        same = (np.asarray(jax.jit(jnp.exp)(x))
                == torch.exp(torch.from_numpy(x)).numpy())
        return x[same][:B * H].reshape(B, H)

    lf = gates(lambda size: -np.abs(rng.normal(size=size)))
    li = gates(rng.normal)
    jy, jst = jax.jit(JLC.linear_attention_step)(
        jnp.asarray(s0), jq, jk, jv, jnp.asarray(lf), jnp.asarray(li))
    state = torch.from_numpy(s0.copy())
    ty, out = TLC.linear_attention_step(state, tq, tk, tv,
                                        torch.from_numpy(lf),
                                        torch.from_numpy(li))
    assert out is state
    np.testing.assert_array_equal(state.numpy(), np.asarray(jst))
    # the read-out q . S sums dk fp32 products in the libraries' orders
    np.testing.assert_allclose(f32(ty), f32(jy), rtol=BF16_ULP, atol=1e-6)


def test_pad_mask_gates_and_readout_match_jax():
    rng = np.random.default_rng(8)
    lf = -np.abs(rng.normal(size=(3, 8, 2))).astype(np.float32)
    li = -np.abs(rng.normal(size=(3, 8, 2))).astype(np.float32)
    vl = np.array([8, 3, 0], np.int32)
    got = TLC.pad_mask_gates(torch.from_numpy(lf), torch.from_numpy(li),
                             torch.from_numpy(vl))
    want = JLC.pad_mask_gates(jnp.asarray(lf), jnp.asarray(li),
                              jnp.asarray(vl))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].min()) == float(np.float32(-1e30))
    assert np.isfinite(got[1].numpy()).all()          # -1e30, not -inf
    jy, ty = _bf16(rng, (2, 5, 3, 9), 4.0)
    np.testing.assert_array_equal(f32(TLC.normalized_readout(ty)),
                                  f32(JLC.normalized_readout(jy)))


def test_ssd_scan_op_raises_on_a_ragged_chunk():
    """``S % min(chunk, S) != 0`` raises, as both references assert."""
    z = torch.zeros((1, 12, 2, 4))
    g = torch.zeros((1, 12, 2))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_op(z, z, z, g, g, chunk=8)
    y, st = ssd_scan_op(z, z, z, g, g, chunk=4)     # 12 = 3 chunks of 4
    assert y.shape == (1, 12, 2, 4) and st.shape == (1, 2, 4, 4)
    y, st = ssd_scan_op(z, z, z, g, g, chunk=256)   # min(256, 12) = 12
    assert y.shape == (1, 12, 2, 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):  # meta
        ssd_scan_op(*(t.to("meta") for t in (z, z, z, g, g)), chunk=8)
    y, st = ssd_scan_op(*(t.to("meta") for t in (z, z, z, g, g)), chunk=4)
    assert (y.device.type, y.shape, st.shape) == ("meta", (1, 12, 2, 4),
                                                  (1, 2, 4, 4))
    with pytest.raises(ValueError):                 # two devices
        ssd_scan_op(z.to("meta"), z, z, g, g, chunk=4)
    with pytest.raises(ValueError):                 # initial state shape
        ssd_scan_op(z, z, z, g, g, chunk=4,
                    initial_state=torch.zeros((1, 2, 4, 5)))


# ---------------------------------------------------------------------------
# no kernel may cut the autograd graph
# ---------------------------------------------------------------------------

def test_refuse_autograd_raises_only_where_a_gradient_is_needed():
    """The check every wrapper makes before it launches its kernel on the
    card (tests/test_torch_cuda.py holds each wrapper to it there): it
    raises, naming the wrapper, when autograd is on and an input requires a
    gradient, and passes under ``torch.no_grad()`` or with none needed."""
    from repro_torch.kernels import refuse_autograd

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="rmsnorm_op"):
        refuse_autograd("rmsnorm_op", torch.ones(3), None, x)
    with torch.no_grad():
        refuse_autograd("rmsnorm_op", x)
    refuse_autograd("rmsnorm_op", x.detach(), None)


@pytest.mark.parametrize("name", ["g3", "x8", "h5", "ed1", "vl7", "mo6"])
def test_training_forward_calls_no_kernel_wrapper(monkeypatch, name):
    """Every family's ``loss_fn`` and its backward reach none of the four
    kernel wrappers (on the card they would launch a kernel that has no
    backward): each wrapper's name in the model code is replaced by one
    that fails, and no launch count moves."""
    from _torch_parity import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import launch_counts
    from repro_torch.models import common as TC
    from repro_torch.models.api import build_model
    from repro_torch.training.grad_compress import _accumulate

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called in training")

    for mod, names in ((TC, ("rmsnorm_op", "flash_attention_op",
                             "decode_attention_op")),
                       (TLC, ("ssd_scan_op",))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    cfg = configs(name)[1]
    model = build_model(cfg, device="cpu",
                        **({"chunk": 8} if name in ("x8", "h5") else {}))
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(
        cfg, ShapeSpec("t", 32, 2, "train")).batch_at(0).items()}
    before = launch_counts()
    loss, grads = _accumulate(model.loss_fn, params, batch, 1)
    assert torch.isfinite(loss)
    assert launch_counts() == before
