"""``repro_torch.launch.hlo_stats.count``: dot FLOPs, kernel work and live
bytes of what a step dispatches (the counterpart of ``tests/
test_hlo_stats.py``), the kernels' work formulas and their meta branch,
the train step's dot FLOPs against the reference's HLO count, and the
collectives' wire bytes against the reference's ring model on its own
compiled ``shard_map`` program."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import ARCHITECTURES as J_ARCHITECTURES
from repro.configs.registry import reduced_config as j_reduced_config
from repro.launch import steps as j_steps
from repro.launch.hlo_stats import analyze_hlo
from repro.launch.mesh import compat_make_mesh
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_op, decode_attention_work)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_op, flash_attention_work)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op, rmsnorm_work
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op, ssd_scan_work
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.launch import hlo_stats
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, make_rank_mesh
from repro_torch.launch.roofline import kernel_bound
from repro_torch.launch.steps import build_step


def test_loop_of_matmuls_counts_every_trip():
    """A Python loop of L matmuls: exactly 2 L B D^2 (the reference's scan
    needs its trip count; a loop here is counted as it runs)."""
    D, L, B = 32, 7, 8
    w = torch.empty((L, D, D), device="meta")
    x = torch.empty((B, D), device="meta")

    def f(w, x):
        for i in range(L):
            x = x @ w[i]
        return x

    stats = hlo_stats.count(f, w, x)
    assert stats.dot_flops == 2.0 * L * B * D * D
    assert stats.dot_flops_by_dtype == {"f32": 2.0 * L * B * D * D}
    assert stats.unknown_trip_whiles == 0
    assert stats.total_collective_bytes == 0.0


def test_nested_loops_multiply():
    D, L1, L2 = 16, 3, 5
    w = torch.randn((L2, D, D))
    x = torch.randn((4, D))

    def f(w, x):
        for _ in range(L1):
            for i in range(L2):
                x = torch.einsum("bd,de->be", x, w[i])
        return x

    assert hlo_stats.count(f, w, x).dot_flops == 2.0 * L1 * L2 * 4 * D * D


def test_dtypes_are_counted_apart():
    a = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16, 4), dtype=torch.bfloat16, device="meta")
    bias = torch.empty((4,), device="meta")

    def f(a, b, bias):
        y = a @ b                                      # bf16 mm
        z = torch.addmm(bias, a.float(), b.float())    # f32 addmm
        q = torch.bmm(a[None].float(), b[None].float())  # f32 bmm
        return y, z, q

    s = hlo_stats.count(f, a, b, bias)
    assert s.dot_flops_by_dtype == {"bf16": 2.0 * 8 * 16 * 4,
                                    "f32": 2 * 2.0 * 8 * 16 * 4}
    assert s.dot_flops == 3 * 2.0 * 8 * 16 * 4


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_live_bytes_peak_is_exact(device):
    """A known sequence of allocations and frees: the peak of live bytes,
    a view adding nothing, and the outputs' and arguments' bytes."""
    arg = torch.zeros(10, device=device)                     # 40 B argument

    def f(arg):
        a = torch.empty(100, device=device)                  # 400
        b = torch.empty(50, device=device)                   # 600
        del a                                                # 200
        c = torch.empty(1000, dtype=torch.bfloat16, device=device)  # 2200
        v = c[10:]                                           # a view: 2200
        del c
        d = v + 1                                            # 4180
        del d, v                                             # 200
        arg.add_(1)                                          # in place
        return b, arg

    s = hlo_stats.count(f, arg)
    assert s.memory == {"argument_bytes": 40, "peak_bytes": 4180,
                        "output_bytes": 200, "alias_bytes": 40}


# ---- the kernels' work, the bound column of PERF.md §6 ----

def test_work_formulas_give_the_bound_column():
    """The four formulas, as ``chip_smoke.py`` calls them, give PERF.md
    §6's bound ms (to its printed digits) at its shapes."""
    cases = [
        (rmsnorm_work(2048, 960), 0.002348, "bytes"),
        (flash_attention_work(8, 256, 15, 5, 64, lengths=[
            256, 200, 129, 256, 131, 140, 250, 180], kv_valid=True),
         0.002937, "bytes"),
        (ssd_scan_work(8, 2048, 25, 16, 64, chunk=256, state_in=True),
         0.12730, "operations"),
        (ssd_scan_work(8, 256, 4, 384, 385, chunk=256, state_in=True),
         0.08522, "operations"),
        (decode_attention_work(8, 15, 5, 64, 256, lengths=[
            0, 1, 37, 128, 200, 255, 256, 64]), 0.000369, "bytes"),
    ]
    for work, ms, by in cases:
        got, got_by = kernel_bound(work)
        digits = len(str(ms).split(".")[1])
        assert round(got, digits) == ms and got_by == by, (work, got)


def test_shapes_only_work_counts_full_rows():
    """Without lengths, decode attends a full cache and flash every key
    row: what the data-dependent formula gives at full lengths."""
    assert (decode_attention_work(4, 15, 5, 64, 512)
            == decode_attention_work(4, 15, 5, 64, 512, lengths=[512] * 4))
    assert (decode_attention_work(2, 8, 2, 64, 512, window=100)
            == decode_attention_work(2, 8, 2, 64, 512, window=100,
                                     lengths=[512, 512]))
    assert (flash_attention_work(3, 40, 6, 2, 16, window=7)
            == flash_attention_work(3, 40, 6, 2, 16, window=7,
                                    lengths=[40] * 3))


def test_flash_work_counts_pairs_row_by_row():
    """The closed form against a loop over rows and keys."""
    B, S, Sk, Hq, D = 2, 24, 40, 4, 16
    for window, lens in ((0, [40, 17]), (9, [40, 33]), (5, [3, 0])):
        pairs = 0
        for n in lens:
            for r in range(S):
                p = r + Sk - S
                pairs += sum(1 for k in range(Sk) if k <= p and k < n
                             and (not window or k > p - window))
        w = flash_attention_work(B, S, Hq, 2, D, Sk=Sk, window=window,
                                 lengths=lens)
        assert w.flops == {"bf16": 4 * D * pairs * Hq}


def test_flash_work_reads_only_the_keys_some_row_attends():
    """The K/V bytes: the keys from the first row's window start to the
    last row's position, below each length, against a loop over rows and
    keys; a context-parallel rank (``q_offset`` < ``Sk - S``) reads only
    the keys its rows see."""
    B, S, Sk, Hq, Hkv, D = 2, 8, 32, 4, 2, 16
    for off, window, lens in ((0, 0, [32, 32]), (8, 0, [32, 11]),
                              (16, 5, [32, 20]), (24, 0, [32, 32]),
                              (8, 0, [0, 32])):
        rows = 0
        for n in lens:
            seen = {k for r in range(S) for k in range(Sk)
                    if k <= off + r and k < n
                    and (not window or k > off + r - window)}
            rows += 2 * len(seen) if n else Sk
        w = flash_attention_work(B, S, Hq, Hkv, D, Sk=Sk, q_offset=off,
                                 window=window, lengths=lens)
        assert w.bytes == (2 * B * S * Hq + rows * Hkv) * D * 2, (off, window)
    # the last rank of a split prefill reads what the default offset reads
    assert (flash_attention_work(B, S, Hq, Hkv, D, Sk=Sk, q_offset=Sk - S)
            == flash_attention_work(B, S, Hq, Hkv, D, Sk=Sk))


def _kernel_calls(device):
    """One call of each wrapper on the same seeded inputs: (name, wrapper
    call, plain-version call)."""
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    x, w, r = randn(6, 32), randn(32), randn(6, 32)
    q, kc, vc = randn(3, 1, 6, 16), randn(3, 24, 2, 16), randn(3, 24, 2, 16)
    ln = torch.tensor([5, 24, 0], dtype=torch.int32).to(device)
    fq, fk, fv = randn(2, 16, 6, 16), randn(2, 16, 2, 16), randn(2, 16, 2, 16)
    kv = torch.tensor([16, 9], dtype=torch.int32).to(device)
    sq, sk, sv = randn(2, 16, 3, 8), randn(2, 16, 3, 8), randn(2, 16, 3, 5)
    lf = -randn(2, 16, 3, dtype=torch.float32).abs()
    li = randn(2, 16, 3, dtype=torch.float32)
    s0 = randn(2, 3, 8, 5, dtype=torch.float32)
    return [
        ("rmsnorm", lambda: rmsnorm_op(x, w), lambda: rmsnorm_ref(x, w)),
        ("rmsnorm", lambda: rmsnorm_op(x, w, residual=r),
         lambda: rmsnorm_ref(x, w, residual=r)),
        ("decode_attention",
         lambda: decode_attention_op(q, kc, vc, ln, window=8),
         lambda: decode_attention_ref(q, kc, vc, ln, window=8)),
        ("flash_attention",
         lambda: flash_attention_op(fq, fk, fv, kv_valid=kv, window=5),
         lambda: flash_attention_ref(fq, fk, fv, kv_valid=kv, window=5)),
        ("ssd_scan",
         lambda: ssd_scan_op(sq, sk, sv, lf, li, chunk=8, initial_state=s0),
         lambda: ssd_scan_ref(sq, sk, sv, lf, li, chunk=8,
                              initial_state=s0)),
    ]


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def test_meta_branch_gives_the_plain_versions_shapes_and_dtypes():
    """On meta tensors each wrapper returns outputs of its plain version's
    shapes and dtypes (the plain version run on the CPU), computes nothing
    and launches nothing."""
    before = {w.__name__: n for w, n in launch_counts().items()}
    for (name, op, _), (_, _, plain) in zip(_kernel_calls("meta"),
                                            _kernel_calls("cpu")):
        got, want = _outs(op()), _outs(plain())
        assert len(got) == len(want), name
        for g, e in zip(got, want):
            assert g.device.type == "meta", name
            assert (g.shape, g.dtype) == (e.shape, e.dtype), name
    assert {w.__name__: n for w, n in launch_counts().items()} == before


def test_recorded_work_is_the_same_on_meta_and_cpu():
    """Under ``count`` each wrapper records its formula's work, and hides
    the plain version's aten ops on the CPU: meta and CPU counts are equal,
    outputs' bytes included, and no dot of a plain version is counted."""
    for (name, op_m, _), (_, op_c, _) in zip(_kernel_calls("meta"),
                                             _kernel_calls("cpu")):
        sm = hlo_stats.count(op_m)
        sc = hlo_stats.count(op_c)
        assert sm.to_dict() == sc.to_dict(), name
        assert sm.memory == sc.memory, name
        assert list(sm.kernel_work) == [name] and sm.dot_flops == 0.0
        assert sm.kernel_work[name]["calls"] == 1


# ---- whole steps ----

REDUCED = ("smollm-360m", "xlstm-125m", "hymba-1.5b", "seamless-m4t-medium",
           "internvl2-1b", "dbrx-132b")
SMALL = {"train": ShapeSpec("t", 32, 4, "train"),
         "prefill": ShapeSpec("p", 32, 2, "prefill"),
         "decode": ShapeSpec("d", 64, 3, "decode")}


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", REDUCED)
def test_step_counts_the_same_on_meta_and_cpu(arch, kind):
    """A reduced step counted on meta tensors and on the CPU (the plain
    versions computing, seeded weights): every count equal, memory
    included."""
    cfg = reduced_config(ARCHITECTURES[arch])
    shape = SMALL[kind]
    meta = build_step(cfg, shape, make_local_mesh(device="meta"))
    cpu = build_step(cfg, shape, make_local_mesh(device="cpu"))
    sm = hlo_stats.count(meta.fn, *meta.arg_specs)
    sc = hlo_stats.count(cpu.fn, *cpu.make_args(0))
    assert sm.to_dict() == sc.to_dict()
    assert sm.memory == sc.memory
    assert sm.dot_flops > 0
    if kind != "train":
        assert "rmsnorm" in sm.kernel_work
    else:
        assert sm.kernel_work == {}      # the training forward runs none


def test_train_step_dot_flops_match_the_reference_hlo():
    """Reduced smollm-360m's train step (remat "none", B 4 x S 64): the
    port's counted dot FLOPs within 5 % of the reference's
    ``analyze_hlo(...).dot_flops`` on a 1 x 1 mesh."""
    jcfg = j_reduced_config(J_ARCHITECTURES["smollm-360m"])
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    with mesh:
        jb = j_steps.build_train_step(jcfg, JShapeSpec("t", 64, 4, "train"),
                                      mesh, remat="none")
        compiled = jb.fn.lower(*jb.arg_specs).compile()
    want = analyze_hlo(compiled.as_text(), total_devices=1).dot_flops
    tb = build_step(reduced_config(ARCHITECTURES["smollm-360m"]),
                    ShapeSpec("t", 64, 4, "train"),
                    make_local_mesh(device="meta"), remat="none")
    assert tb.meta == jb.meta
    got = hlo_stats.count(tb.fn, *tb.arg_specs).dot_flops
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_extrapolate_is_affine_and_exact():
    a = hlo_stats.HloStats(dot_flops=10.0, dot_flops_by_dtype={"f32": 10.0},
                           kernel_work={"k": {"calls": 2, "bytes": 6.0,
                                              "flops": {"f32": 4.0}}},
                           memory={"peak_bytes": 100})
    b = hlo_stats.HloStats(dot_flops=16.0, dot_flops_by_dtype={"f32": 16.0},
                           kernel_work={"k": {"calls": 2, "bytes": 9.0,
                                              "flops": {"f32": 6.0}}},
                           memory={"peak_bytes": 130})
    c = hlo_stats.extrapolate(a, b, 2, 3, 10)
    assert c.dot_flops == 58.0 and c.dot_flops_by_dtype == {"f32": 58.0}
    assert c.kernel_work == {"k": {"calls": 2, "bytes": 30.0,
                                   "flops": {"f32": 20.0}}}
    assert c.memory == {"peak_bytes": 340}
    with pytest.raises(ValueError):
        hlo_stats.extrapolate(a, hlo_stats.HloStats(), 2, 3, 4)


def test_extrapolate_carries_the_collectives():
    """Every collective field lies on the line too (calls rounded to whole
    calls), and two counts that ran different collectives refuse."""
    def stats(n):
        s = hlo_stats.HloStats(dot_flops=1.0)
        s.collective_counts = {"all-gather": n}
        s.collective_bytes = {"all-gather": 3.0 * n}
        s.collective_bytes_by_axes = {"data": 3.0 * n}
        s.collective_payload = {"all_gather/data/bfloat16":
                                {"calls": n, "bytes": 4 * n}}
        return s
    c = hlo_stats.extrapolate(stats(2), stats(3), 2, 3, 16)
    assert c.to_dict() == dict(stats(16).to_dict(), dot_flops=1.0)
    other = stats(3)
    other.collective_payload = {"psum/data/float32": {"calls": 3,
                                                      "bytes": 12}}
    with pytest.raises(ValueError):
        hlo_stats.extrapolate(stats(2), other, 2, 3, 4)


REFERENCE_WIRE = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.sharding import compat_shard_map
from repro.launch.hlo_stats import analyze_hlo
from repro.launch.mesh import compat_make_mesh

mesh = compat_make_mesh((4,), ("model",))


def body(x):
    return (jax.lax.all_gather(x, "model", axis=1, tiled=True),
            jax.lax.psum(x, "model"),
            jax.lax.psum_scatter(x, "model", scatter_dimension=0, tiled=True))


f = compat_shard_map(body, mesh=mesh, in_specs=P("model"),
                     out_specs=(P("model"), P("model"), P("model")))
x = jax.ShapeDtypeStruct((4 * 8, 12), jnp.float32)
hs = analyze_hlo(jax.jit(f).lower(x).compile().as_text(), total_devices=4)
print("REFERENCE " + json.dumps(hs.to_dict()))
"""


def test_wire_bytes_equal_the_references_ring_model():
    """One ``all_gather``, one ``psum`` and one ``psum_scatter`` of an fp32
    [8, 12] block over 4 ranks: the reference's ``analyze_hlo`` of its
    compiled ``shard_map`` program (a subprocess with 4 forced host
    devices) and the port's count on a counting rank of the same 4 give
    the same calls and wire bytes by op. (fp32: XLA's CPU backend carries
    a bf16 collective in fp32, so its HLO would count twice the bytes a
    bf16 transport moves.)"""
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": str(Path.home())}
    if os.environ.get("JAX_PLATFORMS"):
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_WIRE)],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=Path(__file__).resolve().parents[1])
    line = [x for x in r.stdout.splitlines() if x.startswith("REFERENCE ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    want = json.loads(line[0][len("REFERENCE "):])
    mesh = make_rank_mesh((4,), ("model",), {"model": 1})

    def body(x):
        return (sh.all_gather(x, "model", dim=1, mesh=mesh),
                sh.psum(x, "model", mesh=mesh),
                sh.psum_scatter(x, "model", dim=0, mesh=mesh))

    got = hlo_stats.count(body, torch.empty((8, 12), device="meta"),
                          mesh=mesh)
    assert got.collective_counts == want["collective_counts"]
    assert got.collective_bytes == want["collective_bytes"]
    assert got.total_collective_bytes == want["total_collective_bytes"] > 0
    assert got.collective_bytes_by_axes == {
        "model": want["total_collective_bytes"]}


def test_one_device_counts_no_collective():
    """Without a world a step runs no collective: the record keeps the
    reference's keys and no per-axes field."""
    b = build_step(reduced_config(ARCHITECTURES["smollm-360m"]),
                   SMALL["decode"], make_local_mesh(device="meta"))
    d = hlo_stats.count(b.fn, *b.arg_specs, mesh=make_local_mesh(
        device="meta")).to_dict()
    assert d["collective_bytes"] == {} and d["total_collective_bytes"] == 0
    assert "collective_bytes_by_axes" not in d
    assert "collective_payload" not in d


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_softmax_scratch_counts_toward_the_peak(device):
    """``SCRATCH``, as scripts/launch_memory.py measured it on an H100:
    softmax copies a non-contiguous input; its backward holds a buffer of
    the gradient's size, and a copy of a non-contiguous gradient, beside
    its output."""
    aten = torch.ops.aten
    dense = torch.randn((2, 3, 8, 8), device=device)
    strided = torch.randn((2, 8, 3, 8), device=device).transpose(1, 2)
    size = 2 * 3 * 8 * 8 * 4
    for fn, args, peak in (
            (aten._softmax, (dense, -1, False), size),
            (aten._softmax, (strided, -1, False), 2 * size),
            (aten._softmax_backward_data, (dense, dense, -1, torch.float32),
             2 * size),
            (aten._softmax_backward_data,
             (strided, dense, -1, torch.float32), 3 * size),
            (aten.logsumexp, (dense, [-1]), size + size // 8)):
        s = hlo_stats.count(lambda *a: fn(*a), *args)
        assert s.memory["peak_bytes"] == peak, (fn, args[0].stride())
