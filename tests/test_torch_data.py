"""Port-side copy of tests/test_data.py: the port's data pipeline
(``repro_torch.data.pipeline``), determinism, seekability, host sharding."""

import numpy as np
from _hypothesis_compat import given, settings, st

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.data.pipeline import SyntheticLMData

CFG = reduced_config(ARCHITECTURES["smollm-360m"])
SHAPE = ShapeSpec("t", 32, 8, "train")


def test_deterministic_across_instances():
    a = SyntheticLMData(CFG, SHAPE, seed=1).batch_at(7)
    b = SyntheticLMData(CFG, SHAPE, seed=1).batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_seekable_restart_consistency():
    """batch_at(k) equals the k-th element of an iterator from 0, and of an
    iterator resumed at k (bit-exact restart requirement)."""
    ds = SyntheticLMData(CFG, SHAPE, seed=3)
    it = ds.iterator(0)
    for _ in range(4):
        next(it)
    from_iter = next(it)                     # element 4
    np.testing.assert_array_equal(from_iter["tokens"],
                                  ds.batch_at(4)["tokens"])
    resumed = next(ds.iterator(4))
    np.testing.assert_array_equal(resumed["labels"],
                                  ds.batch_at(4)["labels"])


def test_steps_differ():
    ds = SyntheticLMData(CFG, SHAPE, seed=0)
    assert not np.array_equal(ds.batch_at(0)["tokens"],
                              ds.batch_at(1)["tokens"])


def test_host_sharding_partitions_batch():
    full = SyntheticLMData(CFG, SHAPE, seed=0, num_hosts=1).batch_at(0)
    h0 = SyntheticLMData(CFG, SHAPE, seed=0, num_hosts=2, host_id=0).batch_at(0)
    h1 = SyntheticLMData(CFG, SHAPE, seed=0, num_hosts=2, host_id=1).batch_at(0)
    assert h0["tokens"].shape[0] == full["tokens"].shape[0] // 2
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticLMData(CFG, SHAPE, seed=0).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@given(st.integers(0, 1000), st.integers(0, 3))
@settings(max_examples=30, deadline=None)
def test_tokens_in_vocab(step, seed):
    b = SyntheticLMData(CFG, SHAPE, seed=seed).batch_at(step)
    assert b["tokens"].min() >= 0
    assert b["tokens"].max() < CFG.vocab_size


def test_frontend_stub_batches():
    vcfg = reduced_config(ARCHITECTURES["internvl2-1b"])
    b = SyntheticLMData(vcfg, SHAPE, seed=0).batch_at(0)
    assert "prefix_embeddings" in b
    assert b["prefix_embeddings"].shape == (8, vcfg.num_prefix_embeddings,
                                            vcfg.d_model)
    ecfg = reduced_config(ARCHITECTURES["seamless-m4t-medium"])
    b = SyntheticLMData(ecfg, SHAPE, seed=0).batch_at(0)
    assert b["frames"].shape == (8, SHAPE.seq_len, ecfg.d_model)
    assert b["tokens"].shape[1] == SHAPE.seq_len // ecfg.decoder_ratio
