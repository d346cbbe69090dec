"""Port-side copy of tests/test_checkpoint.py: the port's checkpointer
(``repro_torch.checkpoint.checkpointer``), atomic save/restore, bf16
bit-exactness, restore onto another target. The reference's elastic
re-shard test becomes a restore onto another device and dtype: one device
has no shardings, and the target tree says where each leaf lands."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.tree import leaves, tree_map


def _tree(rng):
    return {
        "dense": {"w": torch.tensor(rng.normal(size=(8, 4)),
                                    dtype=torch.float32).to(torch.bfloat16),
                  "b": torch.tensor(rng.normal(size=(4,)),
                                    dtype=torch.float32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def test_roundtrip_bitexact(tmp_path):
    rng = np.random.default_rng(0)
    t = _tree(rng)
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"params": t})
    back = ck.restore(5, "params", tree_map(torch.zeros_like, t))
    for a, b in zip(leaves(t), leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bytes(a) == _bytes(b)


def test_latest_step_and_multiple(tmp_path):
    ck = Checkpointer(str(tmp_path))
    rng = np.random.default_rng(0)
    for s in (1, 3, 10):
        ck.save(s, {"params": _tree(rng)})
    assert ck.steps() == [1, 3, 10]
    assert ck.latest_step() == 10


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    rng = np.random.default_rng(0)
    ck.save(1, {"params": _tree(rng)})
    bad = tree_map(lambda x: torch.empty((9, 9), dtype=x.dtype,
                                         device="meta"), _tree(rng))
    with pytest.raises(ValueError):
        ck.restore(1, "params", bad)


def test_elastic_restore_new_sharding(tmp_path):
    """Restore onto another target than the save's: an fp32 leaf saved from
    one tensor comes back into a bf16 target (rounded to nearest even, as
    ``.to`` rounds) and into a target on the ``meta`` device, each leaf
    landing where its target leaf lives."""
    t = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4) / 3}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": t})
    back = ck.restore(1, "params",
                      {"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t["w"].to(torch.bfloat16))
    meta = ck.restore(1, "params", {"w": torch.empty((4, 4), device="meta")})
    assert meta["w"].device.type == "meta" and meta["w"].shape == (4, 4)


def test_atomic_no_partial_checkpoints(tmp_path):
    """Temp dirs never count as checkpoints."""
    ck = Checkpointer(str(tmp_path))
    (tmp_path / ".tmp_step_00000002").mkdir()
    assert ck.steps() == []
