"""The CUDA RMSNorm kernel's launch geometry, computed in Python and passed
to ``csrc/rmsnorm.cu``, checked on the CPU: which path (16-byte vectors or
one value a load), loads a thread keeps, warps a row and rows a block, at
the serving paths' shapes and at odd ones. Then a model of the kernel's
summation order (each thread's fp32 FMAs over its loads in order, a
butterfly of shuffles across a warp, the warps of a row added in order),
in torch, held within one bf16 rounding (rtol 2**-7) of the plain version
and of the JAX package's ``rmsnorm``, jnp and Pallas (interpret mode), on
the inputs ``tests/test_torch_kernels.py`` uses. Last, the binding imports
where neither ``triton`` nor ``nvcc`` is present, no module of the port
imports Triton, and bf16 is the only dtype the serving paths hand the
wrapper."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm_op as j_rmsnorm_op
from repro.models import common as JC
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import (
    DECODE_BYTES, MAX_THREADS, PREFILL_BYTES, SMS, Geometry, geometry)

from _torch_parity import f32, t_bf16

BF16_ULP = 2.0 ** -7
ROOT = Path(__file__).resolve().parents[1]

# (N, d) on the paths -> (vec, per_thread, row_warps, rows_per_block):
# decode rows (8) and prefill batches of smollm-360m (960), hymba-1.5b
# (1600), xlstm-125m (768), internvl2-1b (896), seamless-m4t-medium (1024)
# and dbrx-132b (6144); 5 x 3000 and 37 x 960 from the card tests
PATH_SHAPES = {
    (8, 960): (8, 2, 2, 1),
    (2048, 960): (8, 4, 1, 2),
    (8, 1600): (8, 2, 4, 1),
    (16384, 1600): (8, 4, 2, 1),
    (8, 768): (8, 2, 2, 1),
    (8, 896): (8, 2, 2, 1),
    (8192, 896): (8, 4, 1, 2),
    (8, 1024): (8, 2, 2, 1),
    (8192, 1024): (8, 4, 1, 2),
    (8, 6144): (8, 3, 8, 1),
    (2048, 6144): (8, 3, 8, 1),
    (5, 3000): (8, 2, 8, 1),
    (37, 960): (8, 2, 2, 1),
}


def _covers(g: Geometry, n: int, d: int) -> None:
    """The launch holds every row and every value of a row once, and no
    thread of a row is without a load."""
    row_threads = 32 * g.row_warps
    units = d // g.vec
    assert d % g.vec == 0
    assert g.threads == row_threads * g.rows_per_block <= MAX_THREADS
    assert g.blocks * g.rows_per_block >= n > (g.blocks - 1) * g.rows_per_block
    # thread t of a row holds loads t, t + T, ..., t + (per_thread - 1) T
    held = sorted(t + j * row_threads for t in range(row_threads)
                  for j in range(g.per_thread) if t + j * row_threads < units)
    assert held == list(range(units))
    assert units > (g.per_thread - 1) * row_threads or g.vec == 1
    if g.row_warps > 1:
        assert g.rows_per_block == 1


@pytest.mark.parametrize("shape", sorted(PATH_SHAPES))
def test_geometry_at_the_paths_shapes(shape):
    n, d = shape
    g = geometry(n, d)
    assert (g.vec, g.per_thread, g.row_warps, g.rows_per_block) == \
        PATH_SHAPES[shape]
    _covers(g, n, d)


@pytest.mark.parametrize("n,d,aligned,want", [
    (8, 1001, True, (1, 16, 2, 1)),        # d % 8: one value a load
    (8, 1000, False, (1, 16, 2, 1)),       # a row not 16-byte aligned
    (2048, 960, False, (1, 32, 1, 2)),
    (8, 3001, True, (1, 16, 8, 1)),        # 12 values a thread, up to 16
    (8, 100, True, (1, 4, 1, 1)),
    (8, 7, True, (1, 1, 1, 1)),
    (8, 6144, False, (1, 32, 8, 1)),
    (3, 16384, True, (8, 8, 8, 1)),        # the widest 16-byte row
    (0, 960, True, (8, 2, 2, 1)),          # no rows: no block
])
def test_geometry_of_odd_shapes(n, d, aligned, want):
    g = geometry(n, d, aligned)
    assert (g.vec, g.per_thread, g.row_warps, g.rows_per_block) == want
    if n:
        _covers(g, n, d)
    else:
        assert g.blocks == 0


@pytest.mark.parametrize("d,aligned", [(16392, True), (8193, True),
                                       (8200, False)])
def test_geometry_refuses_rows_wider_than_eight_warps(d, aligned):
    with pytest.raises(ValueError, match="wider"):
        geometry(8, d, aligned)


@pytest.mark.parametrize("d", [64, 960, 1600, 6144])
def test_decode_rows_spread_and_prefill_rows_pack(d):
    """Up to one row an SM (decode) a row takes at most DECODE_BYTES a
    thread, one row a block; past that (prefill) up to PREFILL_BYTES a
    thread, so no more warps a row, and two rows a block where a row has
    one warp."""
    dec, pre = geometry(SMS, d), geometry(SMS + 1, d)
    assert dec.rows_per_block == 1
    assert dec.per_thread * 16 <= DECODE_BYTES or dec.row_warps == 8
    assert pre.row_warps <= dec.row_warps
    assert pre.per_thread * 16 <= PREFILL_BYTES or pre.row_warps == 8
    assert pre.rows_per_block == (2 if pre.row_warps == 1 else 1)


def kernel_order_rmsnorm(x, w, eps=1e-5, residual=None):
    """RMSNorm summed in ``csrc/rmsnorm.cu``'s order, in torch on the CPU:
    thread t of a row's T threads holds loads t, t + T, ... of ``vec``
    values (``geometry``) and adds their squares in that order with fp32
    FMAs (modelled as an fp64 product and sum rounded to fp32 each step);
    a warp's 32 sums meet in a butterfly (``__shfl_xor_sync`` at 16, 8, 4,
    2, 1); the warps of a row are added in warp order. The scale and the
    weight then apply as in the plain version. Returns what the kernel
    returns: the norm, or (the rounded sum, the norm)."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    if residual is not None:
        xf = xf + residual.float().reshape(-1, d)
    n = xf.shape[0]
    g = geometry(n, d)
    T = 32 * g.row_warps
    padded = torch.zeros((n, g.per_thread * T * g.vec))
    padded[:, :d] = xf
    # value (j T + t) vec + e is thread t's step j vec + e
    steps = padded.view(n, g.per_thread, T, g.vec).transpose(1, 2).reshape(
        n, T, -1).double()
    ss = torch.zeros((n, T))
    for i in range(steps.shape[-1]):
        ss = (ss.double() + steps[..., i] * steps[..., i]).float()
    lanes = ss.view(n, g.row_warps, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ off]
    total = torch.zeros(n)
    for i in range(g.row_warps):
        total = total + lanes[:, i, 0]
    inv = torch.rsqrt(total / d + eps)[:, None]
    y = (xf * inv * w.float()).to(x.dtype).view(x.shape)
    return y if residual is None else (xf.to(x.dtype).view(x.shape), y)


def _bf16(rng, shape, scale=1.0):
    import jax.numpy as jnp
    a = jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)
    return a, t_bf16(f32(a))


def _close(t, j):
    np.testing.assert_allclose(f32(t), f32(j), rtol=BF16_ULP, atol=1e-6)


# test_torch_kernels.py's shapes (d = 64, 96, 960: one or two warps a row,
# 16-byte loads), then the scalar path (d = 1001) and eight warps a row
# (3000, 6144)
@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 96), (3, 960), (4, 1001),
                                   (2, 3000), (2, 6144)])
def test_kernel_summation_order_matches_plain_and_jax(shape):
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, shape)
    jw, tw = _bf16(rng, shape[-1:], 0.25)
    jw, tw = jw + 1, tw + 1
    got = kernel_order_rmsnorm(tx, tw, eps=1e-5)
    _close(got, rmsnorm_ref(tx, tw, eps=1e-5))
    _close(got, JC.rmsnorm(jx, jw, 1e-5))
    _close(got, j_rmsnorm_op(jx, jw, eps=1e-5, interpret=True))


@pytest.mark.parametrize("shape", [(4, 9, 64), (3, 1001), (2, 6144)])
def test_kernel_summation_order_with_the_residual(shape):
    """The residual form against the reference's compiled ``x = x + y;
    rmsnorm(x)``: the sum bit for bit, the norm within one rounding."""
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng, shape)
    jy, ty = _bf16(rng, shape)
    jw, tw = _bf16(rng, shape[-1:], 0.25)

    @jax.jit
    def ref(x, y, w):
        s = x + y
        return s, JC.rmsnorm(s, w + 1, 1e-5)

    js, jh = ref(jx, jy, jw)
    ts, th = kernel_order_rmsnorm(tx, tw + 1, eps=1e-5, residual=ty)
    np.testing.assert_array_equal(f32(ts), f32(js))
    _close(th, jh)
    _close(th, rmsnorm_ref(tx, tw + 1, eps=1e-5, residual=ty)[1])


def test_binding_imports_without_triton_or_nvcc(tmp_path):
    """The binding and the wrapper import, and the wrapper runs on the CPU,
    where ``import triton`` fails and no ``nvcc`` is on the path: nothing
    is compiled or loaded at import."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.rmsnorm import rmsnorm\n"
        "from repro_torch.kernels.rmsnorm.ops import rmsnorm_op\n"
        "y = rmsnorm_op(torch.ones(2, 8), torch.ones(8))\n"
        "assert y.shape == (2, 8) and rmsnorm_op.launches == 0\n"
        "assert _build._lib is None and rmsnorm._lib is None\n"
        "print(rmsnorm.geometry(8, 960))\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Geometry(vec=8, per_thread=2, row_warps=2" in out.stdout


def test_no_port_module_imports_triton():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert words[:2] not in (["import", "triton"],
                                     ["from", "triton"]), path
            assert not any(w.startswith("triton.") for w in words[1:2]
                           if words[:1] in (["import"], ["from"])), path


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_only_bf16_reaches_the_wrapper(arch, monkeypatch):
    """The one (x, w) dtype pair the kernel is compiled for is the only one
    the serving paths hand the wrapper: each architecture, reduced, built
    as ``build_model`` builds it (bf16), through a prefill and a decode
    step, calls ``rmsnorm_op`` with bf16 x, weight and residual only."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
    from repro_torch.models import common
    from repro_torch.models.api import build_model

    seen = []

    def recording(x, w, **kw):
        r = kw.get("residual")
        seen.append((x.dtype, w.dtype, None if r is None else r.dtype))
        return rmsnorm_op(x, w, **kw)

    monkeypatch.setattr(common, "rmsnorm_op", recording)
    cfg = reduced_config(ARCHITECTURES[arch])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 200, (2, 8), generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 16, cfg.d_model), generator=gen)
    if cfg.family == "vlm":
        batch["prefix_embeddings"] = torch.randn((2, 4, cfg.d_model),
                                                 generator=gen)
    with torch.no_grad():
        _, cache = model.prefill(params, batch, max_len=16)
        model.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.long),
                          cache["lengths"])
    bf16 = torch.bfloat16
    assert seen and set(seen) <= {(bf16, bf16, None), (bf16, bf16, bf16)}
