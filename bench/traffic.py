"""The one traffic generator: a traffic mix is a data file of parameters
(``bench/workloads/<cell>.json``) that this module reads.

Open-loop arrivals are a Poisson process of the mix's rate, conditioned on
its counts: ``round(rate * lead_s)`` arrivals drawn uniformly at random
over the lead and ``round(rate * seconds)`` over the window, each set
sorted. Given its count, a Poisson process on an interval is exactly that,
so the arrivals keep Poisson's bursts; only the counts are fixed, so that
every seed offers the window the same number of requests. (The program's
``workloads/traces.py::poisson_trace`` draws the count as well: at 5
requests a second over 51 s its standard deviation alone is 6 % of the
window's work.)

Lengths are the quantiles ``(i + 0.5) / n`` of the mix's distributions,
put in an order drawn from the seed: the window's requests take the
quantiles of their own count, and so do the lead's. A closed loop's pool
is a run of sets of ``backlog`` requests, each set the quantiles of its
count in an order of its own: a window works through some eight of them,
and a pool drawn whole would give each seed another mix. So every seed
offers the window the same counts and lengths, at other times and in
another order, and a run's spread is the system's, not the draw's. The
prompts' token ids also come from the seed.

Parameters of a mix (keys of the file):

* ``mode``: ``"open"`` (requests due on the schedule, whatever the system
  does) or ``"closed"`` (a backlog of ``backlog`` queued requests kept
  full, drawn in order from a pool of about :data:`POOL`);
* ``rate`` (requests a second, open loop), ``lead_s`` (the schedule starts
  this long before the window, so the window sees steady state);
* ``prompt``, ``output``: lists of components ``{"share", "dist": "uniform"
  | "loguniform", "lo", "hi"}`` (bounds inclusive), the shares summing
  to 1;
* ``server``: the server's settings (``slots``, ``max_len``, ``slo_s``)."""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np

# a closed loop's requests: more than any run of the window can finish
POOL = 4096


class Request(NamedTuple):
    due: float              # seconds from the window's start (open loop)
    prompt_len: int
    max_new: int
    index: int              # its place in the schedule


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *salt])


def quantile(components: List[Dict], u: float) -> int:
    """The mixture's length at quantile ``u`` in [0, 1): component by
    share, then its own quantile."""
    acc = 0.0
    for j, c in enumerate(components):
        share = float(c["share"])
        if u < acc + share or j == len(components) - 1:
            v = min(max((u - acc) / share, 0.0), 1.0 - 1e-12)
            lo, hi = int(c["lo"]), int(c["hi"])
            if c["dist"] == "uniform":
                return lo + int(v * (hi - lo + 1))
            if c["dist"] == "loguniform":
                x = math.exp(math.log(lo) + v * (math.log(hi + 1)
                                                 - math.log(lo)))
                return min(hi, max(lo, int(x)))
            raise ValueError(f"unknown distribution {c['dist']!r}")
        acc += share
    raise ValueError("empty mixture")


def lengths(components: List[Dict], n: int,
            rng: np.random.Generator) -> List[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n, in an order drawn from
    ``rng``."""
    vals = [quantile(components, (i + 0.5) / n) for i in range(n)]
    return [vals[i] for i in rng.permutation(n)]


def segments(mix: Dict, seconds: float) -> List[tuple]:
    """(start, length, count) of each stretch of the schedule: the lead
    and the window for an open loop, the sets of the pool for a closed
    one."""
    if mix["mode"] == "closed":
        n = int(mix["backlog"])
        return [(0.0, 0.0, n)] * (POOL // n)
    lead, rate = float(mix["lead_s"]), float(mix["rate"])
    return [(-lead, lead, int(round(rate * lead))),
            (0.0, float(seconds), int(round(rate * seconds)))]


def schedule(mix: Dict, seconds: float, seed: int) -> List[Request]:
    """The run's requests in order of their due time (closed loop: of
    their place in the pool)."""
    out: List[Request] = []
    for k, (start, span, n) in enumerate(segments(mix, seconds)):
        rng = _rng(seed, k)
        due = np.sort(start + span * rng.random(n))
        p = lengths(mix["prompt"], n, rng)
        o = lengths(mix["output"], n, rng)
        out += [Request(float(due[i]), int(p[i]), int(o[i]), len(out) + i)
                for i in range(n)]
    return out


def prompt_tokens(seed: int, req: Request, vocab: int) -> np.ndarray:
    """The prompt's token ids, from the seed and the request's place."""
    return _rng(seed, 4, req.index).integers(
        0, vocab, size=req.prompt_len).astype(np.int32)
