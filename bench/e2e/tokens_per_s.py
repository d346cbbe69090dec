"""Output tokens that reached the host inside the window, unfinished
requests' tokens included, over the window's seconds (host clock)."""


def read(run):
    n = sum(1 for tr in run.requests for t in tr.times if run.in_window(t))
    return n / run.window_s if run.window_s > 0 else None
