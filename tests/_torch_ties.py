"""The bf16 near-tie rule for greedy streams, and the logits recorder it
reads. Imports no JAX, so the card's tests (``test_torch_cuda.py``) use it
too."""

from __future__ import annotations

import numpy as np


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 2.0 ** -133


def record_logits(monkeypatch, srv, engine_module, to_numpy, sync):
    """Record, per request, the logits row each of its tokens was sampled
    from: wraps the engine module's ``sample`` and the server's ``_admit``
    and ``_decode_once``. A prefill's row i belongs to the i-th admitted
    slot in slot order, a decode step's row s to the request in slot s."""
    calls, per_req = [], {}
    sample = engine_module.sample

    def recording_sample(logits, key, **kw):
        to_numpy(logits, calls)
        return sample(logits, key, **kw)

    monkeypatch.setattr(engine_module, "sample", recording_sample)
    admit, decode = srv._admit, srv._decode_once

    def recording_admit(params):
        before, n = set(srv._active), len(calls)
        admit(params)
        sync()
        if len(calls) > n:
            new = sorted(s for s in srv._active if s not in before)
            for i, s in enumerate(new):
                per_req.setdefault(srv._active[s].request_id, []).append(
                    calls[-1][i])

    def recording_decode(params):
        slots = {s: r.request_id for s, r in srv._active.items()}
        n = len(calls)
        decode(params)
        sync()
        if len(calls) > n:
            for s, rid in slots.items():
                per_req[rid].append(calls[-1][s])

    monkeypatch.setattr(srv, "_admit", recording_admit)
    monkeypatch.setattr(srv, "_decode_once", recording_decode)
    return per_req


def assert_streams_within_ties(streams, logits):
    """``streams``: (JAX, port) dicts of request id -> greedy tokens;
    ``logits``: the rows each token was sampled from (``record_logits``).
    Each port stream equals JAX's up to the first step whose two best JAX
    logits lie within one bf16 ulp: there a one-ulp difference from the
    libraries' fp32 summation orders may pick the other token (ROADMAP.md
    §C). A divergence anywhere else fails."""
    for rid, jt in streams[0].items():
        tt = streams[1][rid]
        assert [int(np.argmax(row)) for row in logits[0][rid]] == jt
        assert [int(np.argmax(row)) for row in logits[1][rid]] == tt
        k = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b), None)
        if k is None:
            continue
        row = logits[0][rid][k]
        a, b = jt[k], tt[k]
        gap = float(row[a] - row[b])
        assert gap <= bf16_ulp(max(abs(row[a]), abs(row[b]))), (
            f"request {rid} diverges at token {k}: JAX picks {a} "
            f"(logit {row[a]}), the port {b} (JAX logit {row[b]}): not a "
            f"bf16 near-tie")


def stream_divergence(ref, got, ref_logits, got_logits):
    """``ref``, ``got``: dicts of request id -> greedy tokens, each its own
    logits rows' argmax (``ref_logits``, ``got_logits``); each ``got``
    stream equals ``ref``'s up to the first step where they part (or to
    its end). Returns the largest difference of the two rows over the
    ``ref`` row's largest |logit| across every step up to and including
    that one (the steps whose inputs the two runs share), and the
    ``(request id, step)`` of each parting."""
    worst, parts = 0.0, []
    assert sorted(got) == sorted(ref)
    for rid, rt in ref.items():
        gt, rr, gr = got[rid], ref_logits[rid], got_logits[rid]
        assert [int(np.argmax(row)) for row in rr] == rt
        assert [int(np.argmax(row)) for row in gr] == gt
        assert len(gt) == len(rt)
        k = next((i for i, (a, b) in enumerate(zip(rt, gt)) if a != b),
                 len(rt) - 1)
        for i in range(k + 1):
            worst = max(worst, float(np.abs(gr[i] - rr[i]).max()
                                     / np.abs(rr[i]).max()))
        if rt[k] != gt[k]:
            parts.append((rid, k))
    return worst, parts
