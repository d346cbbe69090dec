"""95th percentile, over every request that delivered at least two tokens
inside the window, of (its last token's time - its first token's time) /
(tokens - 1), counting its tokens from its first (which may precede the
window) up to the window's end; a request still running at the end counts
with the tokens it has (host clock)."""

from bench.stats import percentile


def read(run):
    vals = []
    for tr in run.requests:
        ts = [t for t in tr.times if t <= run.end]
        if sum(1 for t in ts if t >= run.ws) >= 2:
            vals.append((ts[-1] - ts[0]) / (len(ts) - 1))
    return 1e3 * percentile(vals, 95) if vals else None
