"""The traffic generator: deterministic from the seed, Poisson arrivals with
the window's count fixed, and every seed the same lengths in another
order."""

import numpy as np
import pytest

import _tiny  # noqa: F401
from bench import traffic as T

MIX = {"mode": "open", "rate": 12.0, "lead_s": 2.0,
       "prompt": [{"share": 0.75, "dist": "uniform", "lo": 1024,
                   "hi": 2048},
                  {"share": 0.25, "dist": "uniform", "lo": 2049,
                   "hi": 3072}],
       "output": [{"share": 1.0, "dist": "loguniform", "lo": 16, "hi": 64}]}

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, 2 ** 63 + 11]


def window(s, seconds):
    return [r for r in s if 0.0 <= r.due < seconds]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_schedule_and_tokens(seed):
    a = T.schedule(MIX, 10.0, seed)
    b = T.schedule(MIX, 10.0, seed)
    assert a == b
    for r in a[:5]:
        assert np.array_equal(T.prompt_tokens(seed, r, 32001),
                              T.prompt_tokens(seed, r, 32001))


def test_seeds_share_the_work_in_another_order():
    a, b = T.schedule(MIX, 10.0, 1), T.schedule(MIX, 10.0, 2)
    assert [r.due for r in a] != [r.due for r in b]
    wa, wb = window(a, 10.0), window(b, 10.0)
    assert len(wa) == len(wb) == 120
    assert sorted(r.prompt_len for r in wa) == \
        sorted(r.prompt_len for r in wb)
    assert sorted(r.max_new for r in wa) == sorted(r.max_new for r in wb)
    assert [r.prompt_len for r in wa] != [r.prompt_len for r in wb]


@pytest.mark.parametrize("rate,seconds", [(12.0, 10.0), (5.0, 51.0),
                                          (6.5, 13.0), (0.5, 3.0)])
def test_the_lead_and_the_window_hold_their_counts(rate, seconds):
    mix = dict(MIX, rate=rate)
    for seed in (3, 2 ** 35 + 1):
        s = T.schedule(mix, seconds, seed)
        lead = [r for r in s if r.due < 0.0]
        assert len(lead) == round(rate * MIX["lead_s"])
        assert len(window(s, seconds)) == round(rate * seconds)
        assert all(-MIX["lead_s"] <= r.due < seconds for r in s)
        assert [r.due for r in s] == sorted(r.due for r in s)
        assert [r.index for r in s] == list(range(len(s)))


@pytest.mark.parametrize("rate", [5.0, 12.0])
def test_arrivals_bunch_as_poisson_does(rate):
    """Counts in one-second bins have variance about equal to their mean
    (a paced schedule's would be near 0), and some 16 consecutive arrivals
    come in under 0.6 of the 16 / rate a paced schedule gives them."""
    mix = dict(MIX, rate=rate)
    counts, tight = [], 0
    for seed in range(40):
        d = np.array([r.due for r in window(T.schedule(mix, 50.0, seed),
                                            50.0)])
        counts += list(np.histogram(d, bins=50, range=(0.0, 50.0))[0])
        tight += int(np.min(d[16:] - d[:-16]) < 0.6 * 16 / rate)
    c = np.array(counts, dtype=float)
    assert 0.85 < c.var() / c.mean() < 1.15
    assert tight >= 20


def test_lengths_follow_the_mix():
    s = T.schedule(MIX, 30.0, 3)
    p = np.array([r.prompt_len for r in s])
    o = np.array([r.max_new for r in s])
    assert p.min() >= 1024 and p.max() <= 3072
    assert abs((p > 2048).mean() - 0.25) < 0.02
    assert o.min() >= 16 and o.max() <= 64
    # the schedule starts lead_s before the window and covers it
    assert -2.0 <= s[0].due < 0.5 and s[-1].due >= 29.0


def test_prompt_tokens_in_vocab_and_seeded():
    r = T.Request(0.0, 500, 8, 3)
    a = T.prompt_tokens(2 ** 33, r, 300)
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 300
    assert not np.array_equal(a, T.prompt_tokens(2 ** 33 + 1, r, 300))


@pytest.mark.parametrize("backlog", [64, 100])
def test_closed_loop_pool(backlog):
    """Every run of ``backlog`` requests from the pool's start holds the
    same lengths for every seed, in another order."""
    mix = {"mode": "closed", "backlog": backlog, "lead_s": 1.0,
           "prompt": MIX["prompt"], "output": MIX["output"]}
    a, b = T.schedule(mix, 10.0, 5), T.schedule(mix, 10.0, 6)
    assert len(a) == backlog * (T.POOL // backlog) > T.POOL - backlog
    assert all(r.due == 0.0 for r in a)
    assert [r.index for r in a] == list(range(len(a)))
    for k in range(0, len(a), backlog):
        sa, sb = a[k:k + backlog], b[k:k + backlog]
        assert sorted(r.max_new for r in sa) == \
            sorted(r.max_new for r in sb)
        assert sorted(r.prompt_len for r in sa) == \
            sorted(r.prompt_len for r in sb)
    assert [r.max_new for r in a] != [r.max_new for r in b]
