"""Step timelines, request lifecycle tracing, and the SLO flight recorder.

Three layers:

* `Tracer` — a bounded in-memory buffer of Chrome/Perfetto trace events
  (the `chrome://tracing` / https://ui.perfetto.dev JSON array format).
  The engine wraps each region of a step
  (schedule, pack, launch, sample, host bookkeeping) in a span, so a
  step renders as a stacked timeline per track.
* `RequestTracker` — per-request lifecycle records (arrival → admission →
  chunk completions → first token → finish) that yield the serving
  metrics that matter to a caller: TTFT (time to first token), ITL
  (inter-token latency), queue time, and preemption counts.  Each event
  feeds the metrics registry (histograms/counters) and, when a tracer is
  attached, emits one "X" event per finished request on its own
  `req-<id>` track so request lifetimes can be eyeballed against step
  spans in the same Perfetto view.
* `FlightRecorder` — the always-on crash-dump analog for latency: with
  the tracer in ring mode (`ring=True`, newest events overwrite oldest)
  the buffer always holds the *most recent* window of the run, and the
  recorder watches a rolling p95 of step latency against an SLO.  On
  breach it dumps the ring trace + a metrics snapshot once, then stays
  latched until the p95 recovers — a sustained incident yields one
  bounded dump, not a dump per step.

All timestamps come from an injectable `Clock` (default
`time.perf_counter`), so lifecycle math is exactly testable with a
`FakeClock`.
"""
from __future__ import annotations

import collections
import json
import logging
import math
import os
from contextlib import contextmanager
from dataclasses import dataclass, field

from .clock import Clock, PerfCounterClock
from .metrics import LATENCY_BUCKETS_S, Registry

log = logging.getLogger(__name__)


class Tracer:
    """Bounded Chrome trace-event buffer.

    Events use the "trace event format": complete events (`ph: "X"`) with
    `ts`/`dur` in microseconds, grouped by `(pid, tid)`; named tracks are
    realized as thread-name metadata events (`ph: "M"`).  Two overflow
    policies, both bounded (a long serving run degrades to a truncated
    trace, never to unbounded memory) and both counting `dropped`:

    * default (`ring=False`): once `capacity` events are buffered,
      further events are DROPPED — the buffer keeps the *start* of the
      run (good for one-shot export).
    * `ring=True`: the buffer keeps the *last* `capacity` events, newest
      overwriting oldest — the flight-recorder mode, where the tail of
      the run is the part worth dumping on an SLO breach.
    """

    def __init__(self, clock: Clock | None = None, capacity: int = 500_000,
                 pid: int = 1, process_name: str = "repro-serving",
                 ring: bool = False):
        self.clock = clock or PerfCounterClock()
        self.capacity = capacity
        self.pid = pid
        self.ring = ring
        self.dropped = 0
        self._events: "list[dict] | collections.deque[dict]" = (
            collections.deque(maxlen=capacity) if ring else [])
        self._meta: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        self._tids: dict[str, int] = {}

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
            self._meta.append({
                "name": "thread_name", "ph": "M", "pid": self.pid,
                "tid": tid, "args": {"name": track},
            })
        return tid

    def _push(self, ev: dict) -> None:
        if len(self._events) >= self.capacity:
            if self.dropped == 0:
                log.warning(
                    "trace buffer saturated at %d events (%s); see "
                    "repro_trace_dropped_events / summary()",
                    self.capacity,
                    "overwriting oldest" if self.ring else "dropping new")
            self.dropped += 1
            if not self.ring:
                return
        self._events.append(ev)  # ring: deque evicts the oldest event

    def complete(self, name: str, t0: float, t1: float,
                 track: str = "engine", **args) -> None:
        """Record a finished span [t0, t1] (seconds) on `track`."""
        self._push({
            "name": name, "ph": "X", "ts": t0 * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": self.pid, "tid": self._tid(track), "args": args,
        })

    def instant(self, name: str, t: float | None = None,
                track: str = "engine", **args) -> None:
        if t is None:
            t = self.clock.now()
        self._push({
            "name": name, "ph": "i", "ts": t * 1e6, "s": "t",
            "pid": self.pid, "tid": self._tid(track), "args": args,
        })

    @contextmanager
    def span(self, name: str, track: str = "engine", **args):
        t0 = self.clock.now()
        try:
            yield
        finally:
            self.complete(name, t0, self.clock.now(), track=track, **args)

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> list[dict]:
        return list(self._events)

    def to_json(self) -> dict:
        return {"traceEvents": self._meta + list(self._events),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


@dataclass
class RequestRecord:
    """Lifecycle milestones of one request (seconds on the trace clock)."""

    req_id: int
    submit_t: float
    prompt_tokens: int = 0
    admit_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None
    last_token_t: float | None = None
    num_tokens: int = 0
    num_chunks: int = 0
    preemptions: int = 0
    queue_time: float = 0.0
    # True while the request sits in the waiting queue (initially, and
    # again after every preemption); the next chunk/token event closes
    # the wait that started at `_wait_since`.
    queued: bool = True
    _wait_since: float = field(default=0.0, repr=False)

    @property
    def ttft(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def e2e(self) -> float | None:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t


class RequestTracker:
    """Folds request lifecycle events into metrics + trace events."""

    def __init__(self, metrics: Registry, tracer: Tracer | None = None,
                 clock: Clock | None = None):
        self.metrics = metrics
        self.tracer = tracer
        self.clock = clock or (tracer.clock if tracer else PerfCounterClock())
        self.records: dict[int, RequestRecord] = {}
        self._ttft = metrics.histogram(
            "repro_request_ttft_seconds",
            "Submit-to-first-sampled-token latency.",
            buckets=LATENCY_BUCKETS_S)
        self._itl = metrics.histogram(
            "repro_request_itl_seconds",
            "Inter-token latency between consecutive sampled tokens.",
            buckets=LATENCY_BUCKETS_S)
        self._queue = metrics.histogram(
            "repro_request_queue_seconds",
            "Time spent waiting for admission (initial + re-admission "
            "after preemption).",
            buckets=LATENCY_BUCKETS_S)
        self._e2e = metrics.histogram(
            "repro_request_e2e_seconds",
            "Submit-to-finish latency.",
            buckets=LATENCY_BUCKETS_S)
        self._events = metrics.counter(
            "repro_request_events_total",
            "Request lifecycle events by type.",
            labelnames=("event",))

    def _now(self, t: float | None) -> float:
        return self.clock.now() if t is None else t

    def _dequeue(self, rec: RequestRecord, t: float) -> None:
        wait = max(t - rec._wait_since, 0.0)
        rec.queue_time += wait
        rec.queued = False
        if rec.admit_t is None:
            rec.admit_t = t
        self._queue.observe(wait)

    def submit(self, req, t: float | None = None) -> RequestRecord:
        t = self._now(t)
        rec = RequestRecord(
            req_id=req.req_id, submit_t=t,
            prompt_tokens=len(getattr(req, "prompt", ()) or ()),
            _wait_since=t)
        self.records[req.req_id] = rec
        self._events.inc(event="submitted")
        return rec

    def chunk(self, req, t: float | None = None) -> None:
        """A prefill chunk for `req` completed this step."""
        rec = self.records.get(req.req_id)
        if rec is None:
            return
        t = self._now(t)
        rec.num_chunks += 1
        if rec.queued:
            self._dequeue(rec, t)
        self._events.inc(event="chunk")

    def token(self, req, t: float | None = None) -> None:
        """One token was sampled for `req` this step."""
        rec = self.records.get(req.req_id)
        if rec is None:
            return
        t = self._now(t)
        if rec.queued:  # decode-only admission path (no prefill chunk seen)
            self._dequeue(rec, t)
        rec.num_tokens += 1
        if rec.first_token_t is None:
            rec.first_token_t = t
            self._ttft.observe(t - rec.submit_t)
            if self.tracer:
                self.tracer.instant("first_token", t,
                                    track=f"req-{rec.req_id}")
        else:
            self._itl.observe(t - rec.last_token_t)
        rec.last_token_t = t
        self._events.inc(event="token")

    def preempt(self, req, t: float | None = None) -> None:
        rec = self.records.get(req.req_id)
        if rec is None:
            return
        t = self._now(t)
        rec.preemptions += 1
        rec.queued = True
        rec._wait_since = t
        self._events.inc(event="preempted")
        if self.tracer:
            self.tracer.instant("preempted", t, track=f"req-{rec.req_id}")

    def finish(self, req, t: float | None = None) -> None:
        rec = self.records.get(req.req_id)
        if rec is None:
            return
        t = self._now(t)
        rec.finish_t = t
        self._e2e.observe(t - rec.submit_t)
        self._events.inc(event="finished")
        if self.tracer:
            self.tracer.complete(
                f"request {rec.req_id}", rec.submit_t, t,
                track=f"req-{rec.req_id}",
                ttft=rec.ttft, tokens=rec.num_tokens,
                chunks=rec.num_chunks, preemptions=rec.preemptions,
                queue=rec.queue_time)

    def summary(self) -> dict:
        """Aggregate lifecycle stats over all finished requests."""
        done = [r for r in self.records.values() if r.finish_t is not None]
        out = {
            "requests": len(self.records),
            "finished": len(done),
            "preemptions": sum(r.preemptions for r in self.records.values()),
            "tokens": sum(r.num_tokens for r in self.records.values()),
        }
        for name, hist in (("ttft", self._ttft), ("itl", self._itl),
                           ("e2e", self._e2e), ("queue", self._queue)):
            out[f"{name}_p50"] = hist.quantile(0.5)
            out[f"{name}_p95"] = hist.quantile(0.95)
        return out


class FlightRecorder:
    """Rolling p95 step-latency SLO guard with a one-shot breach dump.

    Self-registers on `telemetry` (`telemetry.flight = self`), which then
    feeds every step duration into `observe_step`.  Over the last
    `window` steps a p95 is maintained; once at least `min_steps`
    durations are buffered and the p95 exceeds `slo_p95_s`, the recorder
    dumps the trace buffer (last-N-steps when the telemetry was built
    with `trace_ring=True`) plus one metrics-snapshot line to
    `dump_dir/slo_dump_<k>_{trace.json,metrics.jsonl}` and LATCHES:
    no further dump until the rolling p95 recovers below
    `rearm_ratio * slo_p95_s`.  A sustained breach therefore produces
    exactly one bounded dump, a healthy run none.
    """

    def __init__(self, telemetry, *, slo_p95_s: float, dump_dir: str,
                 window: int = 64, min_steps: int = 16,
                 rearm_ratio: float = 0.8):
        assert slo_p95_s > 0 and 0 < rearm_ratio <= 1.0
        self.telemetry = telemetry
        self.slo_p95_s = float(slo_p95_s)
        self.dump_dir = dump_dir
        self.window = int(window)
        self.min_steps = max(int(min_steps), 1)
        self.rearm_ratio = float(rearm_ratio)
        self.dumps: list[str] = []  # dump path prefixes, oldest first
        self._durs: collections.deque[float] = collections.deque(
            maxlen=self.window)
        self._armed = True
        m = telemetry.metrics
        self._p95_g = m.gauge(
            "repro_step_p95_rolling_seconds",
            "Rolling p95 step latency over the flight-recorder window.")
        self._dumps_c = m.counter(
            "repro_slo_dumps_total",
            "Flight-recorder dumps triggered by a p95 SLO breach.")
        telemetry.flight = self

    def rolling_p95(self) -> float | None:
        if not self._durs:
            return None
        xs = sorted(self._durs)
        return xs[min(math.ceil(0.95 * len(xs)) - 1, len(xs) - 1)]

    def observe_step(self, dt: float, step_idx: int | None = None) \
            -> str | None:
        """One step duration; returns the dump path prefix on breach."""
        self._durs.append(dt)
        p95 = self.rolling_p95()
        self._p95_g.set(p95)
        if len(self._durs) < self.min_steps:
            return None
        if not self._armed:
            if p95 <= self.rearm_ratio * self.slo_p95_s:
                self._armed = True
            return None
        if p95 <= self.slo_p95_s:
            return None
        return self._dump(p95, step_idx)

    def _dump(self, p95: float, step_idx: int | None) -> str:
        self._armed = False
        os.makedirs(self.dump_dir, exist_ok=True)
        prefix = os.path.join(self.dump_dir,
                              f"slo_dump_{len(self.dumps):03d}")
        self.telemetry.tracer.instant(
            "slo_breach", track="engine", p95_s=p95, slo_s=self.slo_p95_s,
            step=step_idx)
        self.telemetry.export_trace(prefix + "_trace.json")
        self.telemetry.write_snapshot(
            prefix + "_metrics.jsonl", reason="slo_p95_breach",
            p95_s=p95, slo_s=self.slo_p95_s, step=step_idx)
        self._dumps_c.inc()
        self.dumps.append(prefix)
        log.warning("step p95 %.6fs breached SLO %.6fs at step %s; "
                    "flight-recorder dump -> %s_{trace.json,metrics.jsonl}",
                    p95, self.slo_p95_s, step_idx, prefix)
        return prefix
