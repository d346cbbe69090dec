"""95th percentile over every request due in the window of the host time
at which the step that prefilled it returned, less its due time; a request
with no first token by the window's end counts at the end."""

from bench.stats import percentile


def read(run):
    vals = [(min(tr.first_t, run.end) if tr.first_t is not None else run.end)
            - tr.due for tr in run.requests if run.in_window(tr.due)]
    return 1e3 * percentile(vals, 95) if vals else None
