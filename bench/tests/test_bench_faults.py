"""A whole run on the CPU at a tiny size, the harness's look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault a serving
cell can have: a token altered where it is produced, a step that leaves
its state unchanged, half of the batch left out. (The exchange between
cards has no place in a one-card cell.) The float8 control reads above
the program at the same size."""

import time

import pytest
import torch

import _tiny
from bench import check, harness


def _token_altered(server, model):
    step = model.decode_step

    def decode_step(params, cache, tokens, lengths):
        logits, cache = step(params, cache, tokens, lengths)
        return logits.roll(1, dims=-1), cache
    model.decode_step = decode_step


def _state_unchanged(server, model):
    step = model.decode_step

    def decode_step(params, cache, tokens, lengths):
        keep = {k: v.clone() for k, v in cache.items() if k != "lengths"}
        logits, out = step(params, cache, tokens, lengths)
        for k, v in keep.items():
            cache[k].copy_(v)
        return logits, out
    model.decode_step = decode_step


def _half_left_out(server, model):
    step = model.decode_step

    def decode_step(params, cache, tokens, lengths):
        logits, cache = step(params, cache, tokens, lengths)
        half = logits.shape[0] // 2
        logits = torch.cat([logits[:half], torch.zeros_like(logits[half:])])
        return logits, cache
    model.decode_step = decode_step


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread while a tiny run is timed on the host clock: the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAULTS = {"sound": None, "token_altered": _token_altered,
          "state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out}


@pytest.mark.parametrize("cell", ["hymba-1.5b.docqa1k", "dbrx-132b.batch"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_run_is_correct_only_when_sound(cell, fault):
    out = harness.run_cell(cell, 2 ** 32 + 17, 2.5, False,
                           t_process=time.perf_counter(), device="cpu",
                           overrides=_tiny.overrides(cell),
                           fault=FAULTS[fault])
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert out["attempted"] > 0
    assert list(out["checks"])[1] == "tokens_compared"
    assert list(out["checks"])[0].endswith("_logit_gap")
    assert list(out)[-1] == "checks"


def test_control_reads_above_the_program():
    cell = "hymba-1.5b.docqa1k"
    p = harness.prepare(cell, 91, device="cpu",
                        overrides=_tiny.overrides(cell))
    from bench import traffic as T
    sched = T.schedule(p.mix, 2.5, 91)
    tracked, *_ = harness.serve(p.server, p.params, p.mix, sched, 91, 2.5,
                                p.vocab)
    done = harness.finished(p, tracked)
    pick = check.sample(done, p.mix, 91, p.conf["window"])
    r = check.control_gap(p.family, p.conf, p.params, pick, p.dev)
    assert r["control"]["max"] > 3 * r["program"]["max"], r
    assert r["control"]["max"] > _tiny.CHECK["gap_limit"] \
        > r["program"]["max"], r
