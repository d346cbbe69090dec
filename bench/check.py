"""Whether what the timed path served is correct.

After the window a sample of the finished requests, drawn from the seed,
goes to the plain float32 reference (``bench/reference/``), which runs
once over each prompt followed by its served tokens. For each served
token the reading is the gap by which the reference's logit of that token
lies below the reference's best logit at its position: 0 where the
program picked what the reference picks, and small where rounding swapped
two nearly equal logits. The number compared is the widest gap over the
sample. The sample holds the request with the most positions, one request
of each prefill path the run took (ladder-padded, and exact past the
ladder's cap), then others in the seed's order until it holds
``check.min_tokens`` served tokens or ``check.max_requests`` requests.

The control (:func:`control_gap`, run by ``bench/tools/control.py`` and
never in a benchmark run) is the same reference with every product's
inputs rounded to float8: at each position of the same prompts and
tokens, the gap of the token the control puts first."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def reference_module(family: str):
    if family == "hybrid":
        from bench.reference import hymba
        return hymba
    if family == "moe":
        from bench.reference import moe
        return moe
    raise ValueError(f"no reference for family {family!r}")


def sample(done, mix: Dict, seed: int, cap=None):
    """The finished requests to compare (``done``: tracked requests);
    ``cap``, where prompts past it take the exact prefill path."""
    chk = mix["check"]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    order = [done[i] for i in rng.permutation(len(done))]

    def size(tr):
        return len(tr.obj.prompt) + len(tr.obj.tokens)

    pick = [max(order, key=size)]
    if cap:
        for want_long in (False, True):
            for tr in order:
                if (len(tr.obj.prompt) > cap) == want_long:
                    if tr not in pick:
                        pick.append(tr)
                    break
    for tr in order:
        if (sum(len(t.obj.tokens) for t in pick) >= int(chk["min_tokens"])
                or len(pick) >= int(chk["max_requests"])):
            break
        if tr not in pick:
            pick.append(tr)
    return pick


def _sequences(pick, dev):
    import torch
    seqs, firsts, served = [], [], []
    for tr in pick:
        p = np.asarray(tr.obj.prompt, np.int64)
        toks = np.asarray(tr.obj.tokens, np.int64)
        seqs.append(torch.from_numpy(np.concatenate([p, toks[:-1]])).to(dev))
        firsts.append(len(p) - 1)
        served.append(torch.from_numpy(toks).to(dev))
    return seqs, firsts, served


def token_gaps(ref_logits, served) -> np.ndarray:
    """Every served token's gap below the reference's best at its
    position (inf where the reference's logits are not finite)."""
    import torch
    out = []
    for lg, tok in zip(ref_logits, served):
        best = lg.max(dim=-1).values
        got = lg.gather(1, tok[:, None]).squeeze(1)
        g = (best - got).double().cpu().numpy()
        if not torch.isfinite(lg).all():
            g[:] = np.inf
        out.append(g)
    return np.concatenate(out) if out else np.zeros(0)


STATISTICS = {
    # the widest gap of any served token
    "max": lambda g: float(g.max()),
    # the mean gap over the served tokens
    "mean": lambda g: float(g.mean()),
}


def judge(family: str, conf: Dict, mix: Dict, params, done, seed: int,
          dev) -> Dict:
    """The verdict of a run: the widest gap over the sample against
    ``check.gap_limit``, and the tokens compared against
    ``check.min_compared``."""
    import torch
    from bench.reference.common import Precision, fp32_mode
    chk = mix["check"]
    pick = sample(done, mix, seed,
                  conf.get("window") if family == "hybrid" else None)
    stat = chk.get("statistic", "max")
    reading, n_tok = float("inf"), 0
    if pick:
        seqs, firsts, served = _sequences(pick, dev)
        ref = reference_module(family)
        with torch.no_grad(), fp32_mode():
            lg = ref.logits_of(params, conf, seqs, firsts, Precision("fp32"))
        reading = STATISTICS[stat](token_gaps(lg, served))
        n_tok = sum(int(s.numel()) for s in served)
    limit = float(chk["gap_limit"])
    least = int(chk["min_compared"])
    ok = bool(pick) and reading <= limit and n_tok >= least
    return {"correct": ok, "requests": len(pick), "checks": {
        f"{stat}_logit_gap": {"value": reading, "limit": limit},
        "tokens_compared": {"value": n_tok, "limit": least}}}


def describe(verdict: Dict) -> List[str]:
    (gap, g), (_, n) = verdict["checks"].items()
    return [f"check {gap} {g['value']!r} limit {g['limit']!r} (at most)",
            f"check tokens_compared {n['value']} limit {n['limit']} "
            f"(at least), over {verdict['requests']} requests"]


def _summary(g: np.ndarray) -> Dict:
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p90": float(np.percentile(g, 90)),
            "share_off": float((g > 1e-6).mean())}


def control_gap(family: str, conf: Dict, params, pick, dev,
                control: bool = True) -> Dict:
    """The program's readings and the float8 control's over the same
    requests: the gaps of the served tokens, and of the tokens the control
    puts first, below the float32 reference's best, summarised by each
    statistic (and the p90 and the share of tokens off the best)."""
    import torch
    from bench.reference.common import Precision, fp32_mode
    seqs, firsts, served = _sequences(pick, dev)
    ref = reference_module(family)
    with torch.no_grad(), fp32_mode():
        lg = ref.logits_of(params, conf, seqs, firsts, Precision("fp32"))
        program = token_gaps(lg, served)
        out = {"program": _summary(program), "tokens": int(program.size)}
        if control:
            ctl = ref.logits_of(params, conf, seqs, firsts,
                                Precision("fp8"))
            out["control"] = _summary(token_gaps(
                lg, [c.argmax(-1) for c in ctl]))
    return out
