"""A counting rank (``launch.mesh.make_rank_mesh``) against the real ranks
of a gloo world on the CPU: the same step, run on the rank's world and
counted on meta at its coordinates, dispatches the same dot FLOPs, the
same kernel work and the same collectives (calls and payload bytes by op,
axes and dtype, and the wire bytes the reference's ring model gives
them). Memory is not compared: a real rank's collectives copy through
buffers a counting rank never makes. Reduced configs (2 layers, d_model
64) on (data 2, model 2) and (pod 2, data 1, model 2), one world of 4
ranks."""

import pytest
import torch

import _torch_dist_ranks as R
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_rank_mesh, run_ranks
from repro_torch.launch.steps import build_step


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_ranks(R.world_counts, 4, device="cpu", timeout=300,
                     tmpdir=str(tmp_path_factory.mktemp("counts")))


@pytest.mark.parametrize("mesh", list(R.COUNT_MESHES))
@pytest.mark.parametrize("arch", R.COUNT_ARCHS)
@pytest.mark.parametrize("step", list(R.COUNT_STEPS))
def test_a_counting_rank_counts_what_its_real_rank_runs(world, mesh, arch,
                                                        step):
    for rank, out in enumerate(world):
        got, want = out[(mesh, arch, step)]
        assert got == want, (rank, mesh, arch, step)
        # every rank moves something, over the axes the rules split
        assert got["collective_payload"], (rank, mesh, arch, step)
        assert got["total_collective_bytes"] > 0
        if step == "serve":
            assert "rmsnorm" in got["kernel_work"]
        else:
            assert not got["kernel_work"]
        if step == "train" and mesh.startswith("pod"):
            # the int8 cross-pod gradient mean
            assert any(k.startswith("all_gather/pod/int8")
                       for k in got["collective_payload"]), got
    # the ranks at other coordinates hold other rows, but run the same
    # SPMD program: equal counts
    assert all(o[(mesh, arch, step)][0] == world[0][(mesh, arch, step)][0]
               for o in world)


def test_a_counting_rank_needs_no_process_group(monkeypatch):
    """A counting rank's train step, backward and optimizer included, with
    every ``torch.distributed`` entry point it could reach made to fail:
    it runs, records its collectives, and no process group exists."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a counting rank called torch.distributed")

    for fn in ("init_process_group", "new_group", "all_reduce", "broadcast",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "get_rank", "get_world_size"):
        monkeypatch.setattr(dist, fn, refuse)
    for fn in ("all_gather_single", "reduce_scatter_single"):
        if hasattr(dist, fn):
            monkeypatch.setattr(dist, fn, refuse)
    mesh = make_rank_mesh((2, 2), ("data", "model"),
                          {"data": 1, "model": 1})
    assert mesh.world.backend == "count" and mesh.world.rank == 3
    assert mesh.world.groups == {}
    assert mesh.world.members[("model",)] == (2, 3)
    assert mesh.world.members[("data",)] == (1, 3)
    assert mesh.world.members[("data", "model")] == (0, 1, 2, 3)
    cfg = reduced_config(ARCHITECTURES["smollm-360m"])
    b = build_step(cfg, ShapeSpec("t", 32, 4, "train"), mesh)
    stats = hlo_stats.count(b.fn, *b.arg_specs, mesh=mesh)
    assert not dist.is_initialized()
    assert stats.collective_payload and stats.dot_flops > 0
    assert {k[0] for k in mesh.world.record.calls} >= {
        "all_gather", "psum", "psum_scatter"}


@pytest.mark.parametrize("op,dim", [("all_gather", 0), ("all_gather", 1),
                                    ("psum_scatter", 1), ("psum", None),
                                    ("pmax", None), ("broadcast", None)])
def test_counting_collectives_return_the_real_shapes(op, dim):
    """Each collective on a counting rank of (data 2, model 4): the shape
    and dtype the real one returns, recorded once with the rank's
    payload."""
    mesh = make_rank_mesh((2, 4), ("data", "model"), {"data": 0, "model": 2})
    x = torch.empty((8, 12), dtype=torch.bfloat16, device="meta")
    fn = getattr(sh, op)
    y = (fn(x, "model", dim=dim, mesh=mesh) if dim is not None
         else fn(x, "model", mesh=mesh))
    want = list(x.shape)
    if op == "all_gather":
        want[dim] *= 4
    elif op == "psum_scatter":
        want[dim] //= 4
    assert list(y.shape) == want and y.dtype == x.dtype
    assert y.device.type == "meta"
    assert mesh.world.record.summary() == [
        {"op": op, "axes": ["model"], "dtype": "bfloat16", "calls": 1,
         "bytes": 8 * 12 * 2}]


def test_backward_collectives_are_counted():
    """The adjoints of a counting rank's collectives are counted too: an
    all_gather's gradient is a psum_scatter, a psum's a psum."""
    mesh = make_rank_mesh((4,), ("model",), {"model": 0})
    w = torch.empty((4, 8), device="meta", requires_grad=True)

    def loss(w):
        g = sh.all_gather(w, "model", mesh=mesh)
        return sh.psum(g.sum(), "model", mesh=mesh)

    def step(w):
        return torch.autograd.grad(loss(w), w)

    stats = hlo_stats.count(step, w, mesh=mesh)
    assert stats.collective_payload == {
        "all_gather/model/float32": {"calls": 1, "bytes": 128},
        "psum/model/float32": {"calls": 2, "bytes": 8},
        "psum_scatter/model/float32": {"calls": 1, "bytes": 512}}
    assert stats.collective_counts == {"all-gather": 1, "all-reduce": 2,
                                       "reduce-scatter": 1}
    assert stats.collective_bytes == {"all-gather": 128 * 3.0,
                                      "all-reduce": 2 * 8 * 3 / 4,
                                      "reduce-scatter": 512 * 3 / 4}
    assert stats.collective_bytes_by_axes == {
        "model": 128 * 3.0 + 2 * 8 * 3 / 4 + 512 * 3 / 4}


def test_rank_rows_own_their_storage():
    """A rank's rows are its own storage (a view would charge the rank the
    whole global batch) and the values slicing gives, with microbatches
    split row by row."""
    mesh = make_rank_mesh((2, 2), ("data", "model"), {"data": 1, "model": 0})
    x = torch.arange(8 * 3).reshape(8, 3)
    for nmb, want in ((1, x[4:8]), (2, torch.cat([x[2:4], x[6:8]]))):
        got = sh.rank_rows({"x": x}, mesh, ("data",), nmb)["x"]
        assert torch.equal(got, want) and got.is_contiguous()
        assert got.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
        assert got.untyped_storage().nbytes() == want.numel() * 8
