"""LM serving engine: continuous batching with Clipper admission control.

Port of ``repro.serving.engine``. Requests (token prompts) enter an
AIMD-governed admission queue (paper §4.3 applied to prefill); admitted
prompts are padded up a geometric *length ladder*
(``core.batching.prompt_length_ladder``), prefilled together, and parked in
decode *slots*; every engine step advances all slots by one token
(continuous batching).

Device-resident hot path: the slot state (the model's cache, a KV cache or
a fixed-size recurrent state, lengths, current tokens, active / generated /
max-new counters) is allocated once at construction and updated in place on
the device; a model's ``decode_step`` writes the cache it is given. That is
this engine's counterpart of the reference's jit buffer donation: decode
never reallocates the cache, and admission writes a whole prefilled batch
into it with one indexed copy per leaf. The fused decode step folds
sampling, per-slot length advance, EOS / max-token / max-length
done-masking and the next-token feedback into device work, so the host sees
exactly one device-to-host copy per step, the packed ``[tokens ‖ done]``.

On the card the fused step is the counterpart of the reference's one jitted
program: the first step with a params tree runs eagerly (on a side stream,
as PyTorch's capture rules ask; it compiles Triton and warms cuBLAS), the
next captures the step once as a CUDA graph, and every later step replays
it. The graph reads the slot state and the params at fixed addresses, so
admission writes the slot state in place, and a step given another params
tree starts over (eager, then a new capture). The server's sampling
generator is registered with the graph, so each replay advances it as an
eager step would. A capture or replay error raises: the card never runs
the step eagerly in its place. The CPU has no graphs and runs the step
eagerly, as the reference's jit runs on any backend.

``fused=False`` is the reference's per-slot loop, kept as the parity and
benchmark baseline: per-request cache scatter at admission, and per step
the sampled tokens plus one device read per active slot on the host. It
runs eagerly on either device.

Not ported: sharding (one device here).

Calibrated-simulation mode (``service_model`` + ``VirtualClock``) advances
the clock by modeled time, so reports are byte-identical per seed."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core.batching import AIMDController, bucket, prompt_length_ladder
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.kernels import credit_launches, launch_counts
from repro_torch.models.api import Model, resolve_device
from repro_torch.serving.sampler import sample

# Calibrated-simulation hook: maps ("prefill", batch, tokens) or
# ("decode", batch, 1) to modeled service seconds, where batch is the
# *executed* shape (padded prefill bucket; all decode slots).
ServiceModel = Callable[[str, int, int], float]


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_time: float
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    prefill_time: Optional[float] = None
    finish_time: Optional[float] = None
    # span tracing: the request's root span and the phase boundaries latency
    # attribution partitions the SLO budget along
    trace: Optional[Any] = None
    dispatch_time: Optional[float] = None     # left the queue for prefill
    prefill_end: Optional[float] = None       # prefill done, decode begins
    # injected per-request failure: the tokens exist but the answer is
    # unusable (a cascade escalates failed drafts)
    failed: bool = False


def make_fused_decode_fn(model: Model, *, temperature: float, eos: int,
                         max_len: int,
                         generator: Optional[torch.Generator] = None):
    """Build the fused device-resident decode step (the engine's hot loop).

    Signature: ``(params, cache, lengths, cur, active, gen, max_new) ->
    packed``. ``cache``, ``lengths``, ``cur``, ``active`` and ``gen`` are
    updated in place; ``packed`` is the single per-step host transfer
    ``cat([tokens, done])`` ([2*slots] int32). A slot finishes when its
    sampled token is EOS, its generated count reaches ``max_new``, or its
    advanced context length reaches ``max_len - 1``."""

    def fused(params, cache, lengths, cur, active, gen, max_new):
        logits, _ = model.decode_step(params, cache, cur, lengths)
        toks = sample(logits, generator, temperature=temperature)
        act = active.to(torch.int32)
        new_len = lengths + act
        new_gen = gen + act
        done = active & ((toks == eos) | (new_gen >= max_new)
                         | (new_len >= max_len - 1))
        packed = torch.cat([toks, done.to(torch.int32)])
        cur.copy_(torch.where(active[:, None], toks[:, None], cur))
        lengths.copy_(new_len)
        gen.copy_(new_gen)
        active.logical_and_(~done)
        return packed

    return fused


def make_decode_fn(model: Model, *, temperature: float,
                   generator: Optional[torch.Generator] = None):
    """The reference loop's decode step: ``(params, cache, tokens, lengths)
    -> tokens`` [slots] int32, the cache updated in place; the host does the
    rest."""

    def decode(params, cache, tokens, lengths):
        logits, _ = model.decode_step(params, cache, tokens, lengths)
        return sample(logits, generator, temperature=temperature)

    return decode


def batched_scatter(cache: Any, pcache: Any, dst: torch.Tensor,
                    src: torch.Tensor) -> None:
    """Copy prefilled rows ``src`` of ``pcache`` into slots ``dst`` of the
    slot cache, in place, one indexed copy per leaf. Walks the cache tree
    (dicts and tuples) as the reference's ``jax.tree.map`` does. Leaves are
    [B] (lengths) or layer-stacked [L, B, ...] (prefill pads K/V to the slot
    cache's ``max_len``)."""
    if isinstance(cache, dict):
        for name, leaf in cache.items():
            batched_scatter(leaf, pcache[name], dst, src)
    elif isinstance(cache, (tuple, list)):
        for leaf, pleaf in zip(cache, pcache, strict=True):
            batched_scatter(leaf, pleaf, dst, src)
    else:
        axis = 0 if cache.dim() == 1 else 1
        cache.index_copy_(axis, dst,
                          pcache.index_select(axis, src).to(cache.dtype))


def _admit_state(lengths, cur, active, gen, max_new, dst, src, vlens, firsts,
                 maxnews) -> None:
    """Batched slot-state update at admission, in place on the device."""
    lengths.index_copy_(0, dst, vlens.index_select(0, src))
    cur.index_copy_(0, dst, firsts.index_select(0, src)[:, None])
    active.index_fill_(0, dst, True)
    gen.index_fill_(0, dst, 1)
    max_new.index_copy_(0, dst, maxnews.index_select(0, src))


def _scatter_cache(cache: Any, pcache: Any, src: int, dst: int) -> None:
    """Copy request ``src`` of a prefill cache into slot ``dst``, in place
    (the reference loop's per-request path; the fused engine uses
    :func:`batched_scatter`)."""
    if isinstance(cache, dict):
        for name, leaf in cache.items():
            _scatter_cache(leaf, pcache[name], src, dst)
    elif isinstance(cache, (tuple, list)):
        for leaf, pleaf in zip(cache, pcache, strict=True):
            _scatter_cache(leaf, pleaf, src, dst)
    elif cache.dim() == 1:                  # lengths [B]
        cache[dst] = pcache[src]
    else:                                   # layer-stacked [L, B, ...]
        cache[:, dst] = pcache[:, src].to(cache.dtype)


class LMServer:
    """Continuous-batching server for one Model, on the model's device."""

    def __init__(self, model: Model, *, device="cuda", slots: int = 8,
                 max_len: int = 256, slo: float = 0.5,
                 temperature: float = 0.0, eos_token: int = -1,
                 seed: int = 0, clock: Callable[[], float] = time.perf_counter,
                 metrics: Optional[MetricsRegistry] = None,
                 service_model: Optional[ServiceModel] = None,
                 model_id: str = "lm", admission_control=None,
                 fused: bool = True, prefill_slo_frac: float = 0.5,
                 pad_prompts: Optional[bool] = None,
                 on_finish: Optional[Callable[["Request"], None]] = None,
                 tracer=None, faults=None, audit=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.eos = eos_token
        self.slo = slo
        self.clock = clock
        self.service_model = service_model
        if service_model is not None and not hasattr(clock, "advance"):
            # modeled service times with a wall clock would mix timelines
            raise ValueError(
                "service_model requires an advanceable clock "
                "(e.g. metrics.VirtualClock) so the whole report shares "
                "one timeline")
        self.model_id = model_id
        self.metrics = metrics if metrics is not None else MetricsRegistry(slo)
        # duck-typed optional hooks (None = off): span tracer, decision
        # audit, SLO-aware admission control, completion callback, and
        # per-request fault injection
        self.tracer = tracer
        self.audit = audit
        self._ts_prev: Dict[str, float] = {}
        self.admission_control = admission_control
        self.shed = 0
        self.on_finish = on_finish
        self.faults = faults
        # prefill-only service time gets its own latency budget — a fraction
        # of the request SLO
        self.prefill_slo_frac = prefill_slo_frac
        self.admission = AIMDController(slo * prefill_slo_frac, additive=1,
                                        init=1, max_batch=slots)
        self.fused = fused
        # the length ladder is the fused path's; the reference loop groups
        # prompts of one length, as the reference's does
        if pad_prompts is None:
            pad_prompts = fused and bool(model.extras.get("prompt_pad"))
        self.pad_prompts = pad_prompts
        self._pad_cap = min(max_len,
                            int(model.extras.get("prompt_pad_cap", max_len)))
        self.length_ladder = prompt_length_ladder(self._pad_cap)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: List[Request] = []
        self._active: Dict[int, Request] = {}      # slot -> request
        self._next_id = 0
        self.completed: Dict[int, Request] = {}
        # hot-path instrumentation
        self.decode_steps = 0
        self.decode_host_syncs = 0
        self.prefill_dispatches = 0
        self.rung_dispatches: Dict[int, int] = {}
        # distinct (batch, prompt_len, padded) prefill shapes dispatched
        self._prefill_shapes: set = set()

        dev = self.device
        self.cache = model.init_cache(slots, max_len)
        self.lengths = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.cur_tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                      device=dev)
        self.active_mask = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self.gen_counts = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.max_new = torch.zeros((slots,), dtype=torch.int32, device=dev)
        if fused:
            self._decode_fused = make_fused_decode_fn(
                model, temperature=temperature, eos=eos_token,
                max_len=max_len, generator=self.generator)
        else:
            self._decode = make_decode_fn(model, temperature=temperature,
                                          generator=self.generator)
        # the fused step's CUDA graph (card only): the params tree it reads
        # (or that the eager step before its capture ran with), the graph,
        # its packed output, and its kernel launches per replay
        self._graph_params: Any = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Optional[torch.Tensor] = None
        self._graph_launches: Dict[Callable, int] = {}
        self.graph_replays = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               now: Optional[float] = None) -> int:
        """Enqueue a prompt. ``now`` (when given) must be on the same
        timeline as this server's ``clock``."""
        rid = self._next_id
        self._next_id += 1
        at = self.clock() if now is None else now
        self.metrics.inc(M.QUERIES_SUBMITTED)
        self.metrics.mark(at)
        trace = None
        if self.tracer is not None:
            trace = self.tracer.start_trace(
                "request", "lm", at, budget_s=self.slo,
                attrs={"rid": rid, "prompt_len": int(len(prompt)),
                       "max_new": max_new_tokens})
        if (self.admission_control is not None
                and not self.admission_control.admit_lm(self, at)):
            self.metrics.inc(M.QUERIES_SHED)
            self.shed += 1
            if self.tracer is not None:
                self.tracer.event(trace, "shed", "lm.admission", at)
                self.tracer.end_trace(trace, at, status="shed")
            return rid              # shed — never queued, never completes
        req = Request(rid, np.asarray(prompt, np.int32), max_new_tokens, at)
        req.trace = trace
        self._queue.append(req)
        return rid

    def est_request_service(self) -> float:
        """Observed engine-seconds per completed request (zero until the
        first completion)."""
        done = self.metrics.counter(M.QUERIES_COMPLETED)
        h = self.metrics.hist(M.SERVICE, model=self.model_id)
        if not done or h is None:
            return 0.0
        return h.total / done

    def _service_time(self, kind: str, batch: int, tokens: int,
                      t0: float) -> float:
        """Measured wall-clock, or modeled time (advancing the injected
        clock) in calibrated-simulation mode."""
        if self.service_model is None:
            return self.clock() - t0
        dt = self.service_model(kind, batch, tokens)
        self.clock.advance(dt)
        return dt

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes dispatched so far — bounded by (batch
        rungs × ladder rungs), not by the distinct prompt lengths."""
        return len(self._prefill_shapes)

    # ------------------------------------------------------------------
    def _take_batch(self, n: int):
        """Dequeue up to ``n`` requests for one prefill dispatch; returns
        ``(batch, padded)``. Ladder mode: the FIFO prefix whose prompts fit
        the pad cap (mixed lengths ride together). Otherwise the
        same-length group around the queue head."""
        if self.pad_prompts and len(self._queue[0].prompt) <= self._pad_cap:
            batch: List[Request] = []
            while (self._queue and len(batch) < n
                   and len(self._queue[0].prompt) <= self._pad_cap):
                batch.append(self._queue.pop(0))
            return batch, True
        plen = len(self._queue[0].prompt)
        batch = []
        for r in list(self._queue):
            if len(r.prompt) == plen and len(batch) < n:
                batch.append(r)
                self._queue.remove(r)
        return batch, False

    def _prefill(self, params, toks: np.ndarray, vlens: np.ndarray,
                 padded: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        shape = (toks.shape[0], toks.shape[1], padded)
        if shape not in self._prefill_shapes:
            self._prefill_shapes.add(shape)
            if self.tracer is not None:
                # first dispatch of a (batch, length) shape
                self.tracer.global_event(
                    "compile", "engine.prefill", self.clock(),
                    attrs={"batch": shape[0], "prompt_len": shape[1],
                           "padded": padded})
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if padded:
            batch["lengths"] = torch.from_numpy(vlens).to(self.device)
        return self.model.prefill(params, batch, max_len=self.max_len)

    def _admit(self, params) -> None:
        free = [s for s in range(self.slots) if s not in self._active]
        if not free or not self._queue:
            return
        n = min(len(free), len(self._queue), self.admission.max_batch_size)
        batch, padded = self._take_batch(n)
        n = len(batch)
        if n == 0:
            return
        self.metrics.observe(M.QUEUE_DEPTH, n + len(self._queue))
        if padded:
            plen = bucket(max(len(r.prompt) for r in batch),
                          ladder=self.length_ladder)
        else:
            plen = len(batch[0].prompt)
        nb = bucket(n, cap=self.slots)
        toks = np.zeros((nb, plen), np.int32)
        vlens = np.full((nb,), plen, np.int32)
        for i, r in enumerate(batch):
            L = len(r.prompt)
            toks[i, :L] = r.prompt
            vlens[i] = L
        t0 = self.clock()
        logits, pcache = self._prefill(params, toks, vlens, padded)
        if self.device.type == "cuda":
            # the reference's block_until_ready(logits): the service time
            # ends with the prefill, before the first token is sampled
            torch.cuda.synchronize(self.device)
        self.prefill_dispatches += 1
        self.rung_dispatches[int(plen)] = (
            self.rung_dispatches.get(int(plen), 0) + 1)
        # the service model is charged the *executed* shape (padded bucket)
        dt = self._service_time("prefill", nb, plen, t0)
        self.admission.record(n, dt)
        self.metrics.inc(M.QUERIES_SUBMITTED, n, model=self.model_id)
        self._observe_batch(n, dt)
        self.metrics.mark(self.clock())
        if self.tracer is not None:
            for r in batch:
                r.dispatch_time = t0
                r.prefill_end = t0 + dt
                if r.trace is not None:
                    self.tracer.add_span(r.trace, "queue", "lm.queue",
                                         r.arrival_time, t0)
                    self.tracer.add_span(
                        r.trace, "prefill", "lm.prefill", t0, t0 + dt,
                        budget_s=self.slo * self.prefill_slo_frac,
                        attrs={"batch": n, "padded_len": int(plen)})
        first = sample(logits, self.generator, temperature=self.temperature)
        first_np = first.cpu().numpy()
        if not self.fused:
            # reference loop: per-request scatter, per-slot state writes
            for i, r in enumerate(batch):
                s = free[i]
                r.slot = s
                r.prefill_time = dt
                r.tokens.append(int(first_np[i]))
                self._active[s] = r
                _scatter_cache(self.cache, pcache, i, s)
                self.lengths[s] = int(vlens[i])
                self.cur_tokens[s, 0] = int(first_np[i])
            return
        maxnews = np.zeros((nb,), np.int32)
        for i, r in enumerate(batch):
            s = free[i]
            r.slot = s
            r.prefill_time = dt
            r.tokens.append(int(first_np[i]))
            self._active[s] = r
            maxnews[i] = r.max_new_tokens
        dev = self.device
        dst = torch.tensor(free[:n], dtype=torch.long, device=dev)
        src = torch.arange(n, dtype=torch.long, device=dev)
        batched_scatter(self.cache, pcache, dst, src)
        _admit_state(self.lengths, self.cur_tokens, self.active_mask,
                     self.gen_counts, self.max_new, dst, src,
                     torch.from_numpy(vlens).to(dev), first,
                     torch.from_numpy(maxnews).to(dev))

    def _decode_once(self, params) -> None:
        if not self._active:
            return
        if self.fused:
            self._decode_once_fused(params)
        else:
            self._decode_once_reference(params)

    def _slot_state(self):
        """The fused step's arguments after ``params``: the slot state."""
        return (self.cache, self.lengths, self.cur_tokens, self.active_mask,
                self.gen_counts, self.max_new)

    def _decode_device(self, params) -> torch.Tensor:
        """Run the fused step on the device; returns the packed ``[tokens ‖
        done]``. CPU: eager. Card: the first step with a params tree eager
        on a side stream, the next captured as a CUDA graph, then replays
        (checked by the params object's identity, once a step)."""
        if self.device.type != "cuda":
            return self._decode_fused(params, *self._slot_state())
        if params is not self._graph_params:
            self._graph = self._graph_out = None
            self._graph_params = params
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                packed = self._decode_fused(params, *self._slot_state())
            main.wait_stream(side)
            return packed
        if self._graph is None:
            self._capture(params)
        self._graph.replay()
        credit_launches(self._graph_launches)
        self.graph_replays += 1
        return self._graph_out

    def _capture(self, params) -> None:
        """Capture the fused step. Capture runs nothing: the wrappers'
        counts of the capture are taken back here and credited per replay."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        try:
            with torch.cuda.graph(graph):
                out = self._decode_fused(params, *self._slot_state())
        finally:
            per_replay = {w: n - before[w]
                          for w, n in launch_counts().items()
                          if n != before[w]}
            credit_launches({w: -n for w, n in per_replay.items()})
        self._graph, self._graph_out = graph, out
        self._graph_launches = per_replay

    def _decode_once_fused(self, params) -> None:
        t0 = self.clock()
        packed = self._decode_device(params)
        out = packed.cpu().numpy()          # the ONE host transfer per step
        self.decode_host_syncs += 1
        toks, done = out[:self.slots], out[self.slots:].astype(bool)
        n_active = len(self._active)
        # executed shape: the decode computes every slot each step
        dt = self._service_time("decode", self.slots, 1, t0)
        self._observe_batch(n_active, dt)
        self.decode_steps += 1
        for s, r in list(self._active.items()):
            r.tokens.append(int(toks[s]))
            if done[s]:
                self._finish(s, r)

    def _decode_once_reference(self, params) -> None:
        """The reference's per-slot loop, kept as the parity and benchmark
        baseline: the sampled tokens to the host, then per active slot a
        token write and a length read (the O(slots) host round trips the
        fused step removes)."""
        t0 = self.clock()
        toks = self._decode(params, self.cache, self.cur_tokens,
                            self.lengths).cpu().numpy()
        self.decode_host_syncs += 1
        n_active = len(self._active)
        dt = self._service_time("decode", self.slots, 1, t0)
        self._observe_batch(n_active, dt)
        self.decode_steps += 1
        self.lengths += torch.tensor(
            [1 if s in self._active else 0 for s in range(self.slots)],
            dtype=torch.int32, device=self.device)
        for s, r in list(self._active.items()):
            t = int(toks[s])
            r.tokens.append(t)
            self.cur_tokens[s, 0] = t
            cur_len = int(self.lengths[s])
            self.decode_host_syncs += 1     # per-slot device read
            if (t == self.eos or len(r.tokens) >= r.max_new_tokens
                    or cur_len >= self.max_len - 1):
                self._finish(s, r)

    def _finish(self, s: int, r: Request) -> None:
        r.done = True
        if self.faults is not None and self.faults.failed(r.request_id):
            r.failed = True
            self.metrics.inc_both(M.FAULTS_TRANSIENT, model=self.model_id)
            self.metrics.inc_both(M.MODEL_FAILURES, model=self.model_id)
            if self.tracer is not None and r.trace is not None:
                self.tracer.event(r.trace, "fault.request_failed",
                                  "lm.fault", self.clock())
        r.finish_time = self.clock()
        self.completed[r.request_id] = r
        del self._active[s]
        if self.tracer is not None and r.trace is not None:
            # exact partition: queue + prefill + decode == latency
            self.tracer.add_span(
                r.trace, "decode", "lm.decode", r.prefill_end, r.finish_time,
                budget_s=self.slo * (1.0 - self.prefill_slo_frac),
                attrs={"tokens": len(r.tokens)})
            latency = r.finish_time - r.arrival_time
            attribution = None
            if latency > 0:
                attribution = {
                    "lm.queue": r.dispatch_time - r.arrival_time,
                    "lm.prefill": r.prefill_end - r.dispatch_time,
                    "lm.decode": r.finish_time - r.prefill_end,
                }
            self.tracer.end_trace(r.trace, r.finish_time,
                                  attribution=attribution,
                                  attrs={"tokens": len(r.tokens)})
        self.metrics.inc_both(M.QUERIES_COMPLETED, model=self.model_id)
        self.metrics.observe_latency(r.finish_time - r.arrival_time,
                                     model=self.model_id)
        self.metrics.mark(r.finish_time)
        if self.on_finish is not None:
            self.on_finish(r)

    def _observe_batch(self, size: int, service: float) -> None:
        """One dispatched batch (prefill or decode) into the shared schema."""
        self.metrics.inc_both(M.BATCHES, model=self.model_id)
        self.metrics.observe_both(M.BATCH_SIZE, size, model=self.model_id)
        self.metrics.observe_both(M.SERVICE, service, model=self.model_id)

    @property
    def pending(self) -> bool:
        """True while any request is queued or decoding."""
        return bool(self._queue or self._active)

    def timeseries_probe(self, now: float, dt: float) -> Dict[str, float]:
        """Fleet-sampler probe: slot occupancy, queue depth, AIMD prefill
        budget, shed/throughput rates, and per-rung dispatch rates.
        Read-only on the engine."""
        mid = self.model_id

        def rate(key: str, cur: float) -> float:
            prev = self._ts_prev.get(key, 0.0)
            self._ts_prev[key] = cur
            return (cur - prev) / dt

        out = {
            f"lm.slots_active.{mid}": float(len(self._active)),
            f"lm.slots_free.{mid}": float(self.slots - len(self._active)),
            f"lm.queue_depth.{mid}": float(len(self._queue)),
            f"lm.aimd_budget.{mid}": float(self.admission.max_batch_size),
            f"lm.est_service.{mid}": self.est_request_service(),
            f"lm.lambda.{mid}": rate(
                "submitted", self.metrics.counter(M.QUERIES_SUBMITTED)),
            f"lm.throughput.{mid}": rate(
                "completed", self.metrics.counter(M.QUERIES_COMPLETED)),
            f"lm.shed_rate.{mid}": rate(
                "shed", self.metrics.counter(M.QUERIES_SHED)),
            f"lm.decode_steps.{mid}": rate("decode", self.decode_steps),
            f"lm.prefill_dispatches.{mid}": rate(
                "prefill", self.prefill_dispatches),
        }
        for plen, n in sorted(self.rung_dispatches.items()):
            out[f"lm.rung_dispatches.{plen}.{mid}"] = rate(
                f"rung.{plen}", n)
        return out

    def step(self, params) -> None:
        self._admit(params)
        self._decode_once(params)

    def run(self, params, *, max_steps: int = 10_000) -> None:
        steps = 0
        while self.pending and steps < max_steps:
            self.step(params)
            steps += 1

    @property
    def stats(self) -> Dict[str, Any]:
        return {
            "completed": len(self.completed),
            "shed": self.shed,
            "admission_max_batch": self.admission.max_batch_size,
            "decode_steps": self.decode_steps,
            "decode_host_syncs": self.decode_host_syncs,
            "host_syncs_per_decode_step": (
                self.decode_host_syncs / self.decode_steps
                if self.decode_steps else 0.0),
            "prefill_compiles": self.prefill_compiles,
            "prefill_dispatches": self.prefill_dispatches,
        }

    def engine_report(self) -> Dict[str, Any]:
        """Engine-level counters: prefill shapes dispatched, how chatty the
        decode loop is with the host, which attention implementation ran
        (``"plain"`` PyTorch on the CPU, ``"kernels"`` on the card), and
        whether the fused step replayed as a CUDA graph."""
        return {
            "fused": self.fused,
            "attention_backend": ("kernels" if self.device.type == "cuda"
                                  else "plain"),
            "prefill": {
                "dispatches": self.prefill_dispatches,
                "compiled_shapes": self.prefill_compiles,
                # shapes dispatched: [batch, prompt_len, padded]
                "shapes": [list(k) for k in sorted(self._prefill_shapes)],
                "rung_dispatches": {str(k): v for k, v in
                                    sorted(self.rung_dispatches.items())},
            },
            "decode": {
                "steps": self.decode_steps,
                "host_syncs": self.decode_host_syncs,
                "host_syncs_per_step": (
                    self.decode_host_syncs / self.decode_steps
                    if self.decode_steps else 0.0),
                "graph": self.graph_replays > 0,
            },
        }

    def report(self) -> Dict[str, Any]:
        """Canonical telemetry report (``repro.metrics/v1`` schema) plus the
        ``engine`` section; with a tracer attached it also gains
        ``latency_attribution`` and a ``trace`` summary."""
        rep = self.metrics.report("lmserver")
        rep["engine"] = self.engine_report()
        if self.tracer is not None:
            rep["latency_attribution"] = self.tracer.attribution_report()
            rep["trace"] = self.tracer.summary()
        return rep

    def report_json(self, **extra: Any) -> str:
        rep = self.report()
        rep.update(extra)
        return json.dumps(rep, sort_keys=True, indent=2)
