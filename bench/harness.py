"""One run of one cell: load, warm, serve the traffic for the window, read
the metrics, check the outputs.

The system under test is the port's ``LMServer`` (``repro_torch.serving.
engine``) with ``fused=True`` at temperature 0, driven through its public
``submit(prompt, max_new_tokens, now=)`` and ``step(params)``. Everything
that belongs to one configuration, traffic mix or metric lives in a file
of its own that this module finds by the names in ``BENCHMARK.json``:

* ``bench/configs/<config>.json``: the model's sizes (the fields of the
  port's ``ModelConfig``), its ``family`` and its source;
* ``bench/workloads/<cell>.json``: the traffic mix (``bench/traffic.py``),
  the server's settings and the check's sample and limit;
* ``bench/e2e/<metric>.py`` and ``bench/metrics/<metric>.py``: a reader
  each, ``read(run) -> float | None``, over the :class:`Run` below.

A run records, on the host clock, every request's due time and the time
each of its tokens reached the host (the return of the ``step`` that
produced it). With ``trace`` it also wraps the server's admission and
decode calls to record their intervals and what they served, attaches the
program's span tracer, and runs ``torch.profiler`` over
the window's last ``trace_seconds``."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from bench import traffic as T

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# the fields of the port's ModelConfig that a configuration file may set
MODEL_FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
                "num_kv_heads", "d_ff", "vocab_size", "num_experts",
                "num_experts_per_tok", "moe_capacity_factor", "rope_theta",
                "window", "global_layers", "ssm_state", "conv_width",
                "norm_eps")


def manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(man: Dict, workload: str):
    """(cell entry, configuration dict, traffic dict) of ``workload``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(BENCH / "workloads" / f"{workload}.json"))


def reader(kind: str, name: str) -> Callable:
    """``read`` of ``bench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Tracked:
    """What the host saw of one request."""

    __slots__ = ("due", "obj", "seen", "first_t", "times")

    def __init__(self, due: float, obj):
        self.due, self.obj = due, obj
        self.seen = 0
        self.first_t: Optional[float] = None
        self.times: List[float] = []        # host time of each token


class Run:
    """Everything a metric reader may read. Times are host seconds
    (``time.perf_counter``).

    ``cfg``, ``family``, ``mix``: the configuration, its family, the mix.
    ``setup_s``: process start to the start of the traffic schedule.
    ``ws``, ``end``: the window's start and the return of its last step.
    ``requests``: :class:`Tracked` of every request sent.
    ``stats0``, ``stats1``: ``LMServer.stats`` at the window's start and
    end. ``lateness``: how late each request was sent after its due time.
    Traced runs only: ``admits`` and ``decodes``, one dict per admission
    or decode call in the window (``t0``, ``t1``; an admission's
    ``lengths`` of the prompts it prefilled, ``rung`` and ``padded``; a
    decode's ``positions`` of its active slots' current tokens;
    ``traced``: inside the profiled span); ``profiled``, the profiled
    span's host start and end, or None; ``spans``, the tracer's spans;
    ``trace``, the profiled span's reduction (``bench/trace.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def in_window(self, t: float) -> bool:
        return self.ws <= t <= self.end

    @property
    def window_s(self) -> float:
        return self.end - self.ws


def model_config(conf: Dict):
    from repro_torch.configs.base import ModelConfig
    kw = {k: conf[k] for k in MODEL_FIELDS if k in conf}
    if "global_layers" in kw:
        kw["global_layers"] = tuple(kw["global_layers"])
    return ModelConfig(**kw)


def warm_shapes(server, mix: Dict) -> List[tuple]:
    """The prefill shapes ``(batch, length, padded)`` the mix can
    dispatch: every batch rung up to the slots at every ladder rung its
    prompts reach; past the ladder's cap (or where the model pads no
    prompt) one exact shape each of one and two prompts of the middle
    length."""
    from repro_torch.core.batching import bucket
    lo = min(int(c["lo"]) for c in mix["prompt"])
    hi = max(int(c["hi"]) for c in mix["prompt"])
    batches = sorted({bucket(n, cap=server.slots)
                      for n in range(1, server.slots + 1)})
    shapes = []
    if server.pad_prompts and lo <= server._pad_cap:
        prev = 0
        for r in server.length_ladder:
            if r >= lo and prev < hi:
                shapes += [(b, r, True) for b in batches]
            prev = r
    if not server.pad_prompts or hi > server._pad_cap:
        first = max(lo, server._pad_cap + 1) if server.pad_prompts else lo
        mid = (first + hi) // 2
        shapes += [(1, mid, False), (2, mid, False)]
    return shapes


def warm(server, params, mix: Dict, vocab: int, sync: Callable) -> None:
    """Run every prefill shape of :func:`warm_shapes` once, then serve one
    short request to the end: its first decode step runs eagerly, the
    second captures the step's CUDA graph, the later ones replay it."""
    import torch
    dev = server.device
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for b, n, padded in warm_shapes(server, mix):
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, vocab, size=(b, n)).astype(np.int32)).to(dev)}
            if padded:
                batch["lengths"] = torch.full((b,), n, dtype=torch.int32,
                                              device=dev)
            server.model.prefill(params, batch, max_len=server.max_len)
            sync()
    server.submit(rng.integers(0, vocab, size=16).astype(np.int32),
                  max_new_tokens=6)
    while server.pending:
        server.step(params)
    sync()


def _wrap(server, run_log: Dict, clock) -> None:
    """Record each admission and decode call's interval and work; under
    the profiler each carries a ``record_function`` label."""
    from torch.profiler import record_function
    admit, decode = server._admit, server._decode_once

    def rec_admit(params):
        before = set(server._active)
        rungs = dict(server.rung_dispatches)
        t0 = clock()
        with record_function("bench.admit"):
            admit(params)
        t1 = clock()
        new = [server._active[s] for s in server._active
               if s not in before]
        if not new and server.rung_dispatches == rungs:
            return
        rung = [k for k, v in server.rung_dispatches.items()
                if v != rungs.get(k, 0)]
        lens = [len(r.prompt) for r in new]
        if run_log["on"]:
            run_log["admits"].append(dict(
                t0=t0, t1=t1, lengths=lens, rung=rung[0] if rung else
                max(lens), padded=bool(server.pad_prompts and max(lens)
                                       <= server._pad_cap),
                traced=run_log["traced"]))

    def rec_decode(params):
        pos = [len(r.prompt) + len(r.tokens) - 1
               for r in server._active.values()]
        t0 = clock()
        with record_function("bench.decode"):
            decode(params)
        t1 = clock()
        if pos and run_log["on"]:
            run_log["decodes"].append(dict(t0=t0, t1=t1, positions=pos,
                                           traced=run_log["traced"]))

    server._admit, server._decode_once = rec_admit, rec_decode


def serve(server, params, mix: Dict, sched: List[T.Request], seed: int,
          seconds: float, vocab: int, *, clock=time.perf_counter,
          trace_seconds: float = 0.0, run_log: Optional[Dict] = None,
          on_window: Optional[Callable] = None):
    """Serve the schedule from ``lead_s`` before the window to its end.
    Returns (tracked requests, window start, end, lateness, stats at the
    window's start and end, profiler or None)."""
    import torch
    closed = mix["mode"] == "closed"
    backlog = int(mix.get("backlog", 0))
    lead = float(mix.get("lead_s", 0.0))
    tracked: List[Tracked] = []
    live: List[Tracked] = []
    lateness: List[float] = []
    start = clock()
    ws = start + lead
    we = ws + seconds
    prof = None
    # the profiled span ends with the window: stopping the profiler takes
    # seconds, which must not stall the window
    t_prof = we - trace_seconds if trace_seconds > 0 else math.inf
    stats0 = None
    nxt = 0

    def send(req: T.Request, due: float, now: float):
        server.submit(T.prompt_tokens(seed, req, vocab),
                      max_new_tokens=req.max_new, now=due)
        tr = Tracked(due, server._queue[-1])
        tracked.append(tr)
        live.append(tr)
        lateness.append(now - due)

    while True:
        now = clock()
        if stats0 is None and now >= ws:
            stats0 = dict(server.stats)
            if run_log is not None:
                run_log["on"] = True
            if on_window is not None:
                on_window()
        if prof is None and now >= t_prof:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            t_ask = clock()
            prof.start()
            prof_t = [clock(), None]
            print(f"bench: profiler started in {prof_t[0] - t_ask:.3f} s",
                  file=sys.stderr)
            run_log["traced"] = True
        if now >= we:
            break
        if closed:
            while len(server._queue) < backlog and nxt < len(sched):
                send(sched[nxt], now, now)
                nxt += 1
        else:
            while nxt < len(sched) and ws + sched[nxt].due <= now:
                send(sched[nxt], ws + sched[nxt].due, now)
                nxt += 1
        if server.pending:
            server.step(params)
            t = clock()
            keep = []
            for tr in live:
                n = len(tr.obj.tokens)
                if n > tr.seen:
                    if tr.first_t is None:
                        tr.first_t = t
                    tr.times.extend([t] * (n - tr.seen))
                    tr.seen = n
                if not tr.obj.done:
                    keep.append(tr)
            live[:] = keep
        else:
            wait = min((ws + sched[nxt].due if nxt < len(sched) and not
                        closed else we), we) - clock()
            if wait > 0.002:
                time.sleep(wait - 0.001)
    end = clock()
    if prof is not None:
        torch.cuda.synchronize()
        prof_t[1] = clock()
        run_log["traced"] = False
        prof.stop()
    if run_log is not None:
        run_log["on"] = False
    return (tracked, ws, end, lateness, stats0 or dict(server.stats),
            dict(server.stats), (prof, prof_t) if prof is not None
            else None)


def _profiler_ready(dev) -> None:
    """Start and stop the profiler once on a trivial op: its first start
    loads and initialises the device tracer, which takes seconds, and
    would otherwise eat the profiled span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=dev).add_(1)
        torch.cuda.synchronize()


def read_metrics(run: Run, entries: List[Dict], kind: str,
                 workload: str) -> Dict[str, Dict]:
    """Each metric of ``entries`` that applies to ``workload`` and whose
    reader finds something to read."""
    out = {}
    for m in entries:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = reader(kind, m["name"])(run)
        if v is None:
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def banned_modules(names=None) -> List[str]:
    """Of ``names`` (default: the loaded modules), the top-level names of
    JAX, its libraries and the JAX package, compared whole (the port's
    name begins with the JAX package's)."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in bad})


class Prepared:
    """A cell ready to serve: its files, model, weights and warm server."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def prepare(workload: str, seed: int, *, device: str = "cuda",
            overrides: Optional[Dict] = None, trace: bool = False,
            fault: Optional[Callable] = None, model=None) -> Prepared:
    """Build the cell's model (or take ``model``), make the weights from
    ``seed``, start a server and warm it.

    ``overrides`` replaces keys of the configuration (``"config"``) and of
    the mix (``"mix"``): the CPU tests run a tiny model through this same
    path. ``fault(server, model)``, a test's, breaks the timed path."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.obs.tracer import Tracer
    from repro_torch.serving.engine import LMServer
    from bench import weights

    man = manifest()
    cell, conf, mix = cell_files(man, workload)
    if overrides:
        conf = {**conf, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    family = conf["family"]
    if model is None:
        model = build_model(model_config(conf), device=dev,
                            dtype=torch.bfloat16)
    params = weights.make_params(family, conf, seed, dev)
    srv_cfg = mix["server"]
    tracer = Tracer(sample_rate=1.0, seed=0) if trace else None
    server = LMServer(model, device=dev, slots=int(srv_cfg["slots"]),
                      max_len=int(srv_cfg["max_len"]),
                      slo=float(srv_cfg["slo_s"]), temperature=0.0,
                      seed=int(seed) % (2 ** 63), fused=True, tracer=tracer)
    if fault is not None:
        fault(server, model)
    vocab = int(conf["vocab_size"])
    warm(server, params, mix, vocab, sync)
    return Prepared(man=man, cell=cell, conf=conf, mix=mix, dev=dev,
                    cuda=cuda, sync=sync, family=family, model=model,
                    params=params, server=server, tracer=tracer,
                    vocab=vocab, warm_ids=set(server.completed))


def release(p: Prepared) -> None:
    """Free the server's cache and graph (the weights stay)."""
    import torch
    p.server.cache = None
    p.server._graph = p.server._graph_out = None
    p.server = None
    if p.cuda:
        torch.cuda.empty_cache()


def finished(p: Prepared, tracked: List[Tracked]) -> List[Tracked]:
    return [tr for tr in tracked if tr.obj.done
            and tr.obj.request_id not in p.warm_ids]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: str = "cuda",
             overrides: Optional[Dict] = None,
             fault: Optional[Callable] = None) -> Dict[str, Any]:
    """One run of ``workload``; returns the result line's object
    (``overrides``, ``fault``: :func:`prepare`'s)."""
    import torch
    from bench import check
    from bench import trace as TR

    p = prepare(workload, seed, device=device, overrides=overrides,
                trace=trace, fault=fault)
    conf, mix, server = p.conf, p.mix, p.server
    sched = T.schedule(mix, seconds, seed)
    run_log = {"on": False, "traced": False, "admits": [], "decodes": []}
    if trace:
        _wrap(server, run_log, time.perf_counter)
        if p.cuda:
            _profiler_ready(p.dev)
    setup_s = time.perf_counter() - t_process
    tracked, ws, end, lateness, s0, s1, prof = serve(
        server, p.params, mix, sched, seed, seconds, p.vocab,
        trace_seconds=(float(mix.get("trace_seconds", 2.0))
                       if trace and p.cuda else 0.0),
        run_log=run_log)
    peak = int(torch.cuda.max_memory_allocated()) if p.cuda else 0
    run = Run(cfg=conf, family=p.family, mix=mix, setup_s=setup_s, ws=ws,
              end=end, requests=tracked, stats0=s0, stats1=s1,
              lateness=lateness, admits=run_log["admits"],
              decodes=run_log["decodes"],
              spans=p.tracer.spans() if p.tracer else [], trace=None,
              profiled=tuple(prof[1]) if prof is not None else None)
    device_info = {"platform": "gpu" if p.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if p.cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if prof is not None:
        run.trace = TR.reduce(prof[0], prof[1][0], prof[1][1])
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        breakdown = run.trace["breakdown"]
    if trace:
        metrics = read_metrics(run, p.man["per_layer"], "metrics", workload)
    else:
        metrics = read_metrics(run, p.man["end_to_end"], "e2e", workload)
    # the program's state goes before the reference runs on the card
    done = finished(p, tracked)
    release(p)
    verdict = check.judge(p.family, conf, mix, p.params, done, seed, p.dev)
    late = sorted(lateness)
    print(f"bench: window {end - ws:.3f} s, {len(tracked)} requests sent, "
          f"generator late p50 {1e3 * _q(late, 0.5):.3f} ms, p95 "
          f"{1e3 * _q(late, 0.95):.3f} ms, max "
          f"{1e3 * (late[-1] if late else 0.0):.3f} ms; decode steps "
          f"{s1['decode_steps'] - s0['decode_steps']}, prefill dispatches "
          f"{s1['prefill_dispatches'] - s0['prefill_dispatches']}",
          file=sys.stderr)
    for line in check.describe(verdict):
        print(line, file=sys.stderr)
    out = {"correct": verdict["correct"],
           "attempted": sum(1 for tr in tracked if run.in_window(tr.due)),
           "failed": int(s1.get("shed", 0) - s0.get("shed", 0)),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = verdict["checks"]
    return out


def _q(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals), 100 * q))
