"""The serving-side telemetry facade.

One `Telemetry` object owns the metrics `Registry`, the Chrome-trace
`Tracer`, and the `RequestTracker`, and exposes the handful of hooks the
engine/scheduler/prefix-cache call.  When an `Engine` is built without
telemetry (`telemetry=None`, the default) none of these hooks run and the
serving loop does not synchronise on a launch for timing — the
observability layer costs nothing when disabled (the
`telemetry-overhead` bench scenario guards the enabled cost too).

Beyond metrics and traces, `Telemetry` accumulates the **latency grid**:
per (phase, bucketed `BatchProfile`, `KernelConfig`) observed launch
latency stats.  `export_latency_grid()` writes it in a
microbench-compatible shape that `autotune.tune.refit_from_telemetry`
accepts to refit the unified/decode/prefill heuristics trees from
production traffic instead of offline sweeps — the telemetry→autotune
refit loop (see docs/observability.md).  Compile-bearing launches are
excluded from the grid (and from the warm-launch histograms): a refit
must see steady-state replay latency, not trace+compile time.

Metric names (all prefixed `repro_`) are documented in
docs/observability.md.
"""
from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager

from .clock import Clock, PerfCounterClock
from .metrics import LATENCY_BUCKETS_S, TOKEN_BUCKETS, Registry
from .tracing import RequestTracker, Tracer


@dataclasses.dataclass
class _LaunchStat:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    # device-side cost of the executable behind this grid key (the
    # engine's analytic count, stamped once at capture); None when unknown
    flops: float | None = None
    bytes: float | None = None

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


class Telemetry:
    def __init__(self, *, clock: Clock | None = None,
                 trace_capacity: int = 500_000, max_series: int = 512,
                 launch_timing_interval: int = 8,
                 trace_ring: bool = False):
        self.clock = clock or PerfCounterClock()
        # Precise launch timing needs a barrier on the launch's output
        # (a synchronisation on the card), which
        # costs the host/device overlap between launch and the sample
        # pull — the dominant enabled-telemetry cost.  So warm launches
        # are only timed every Nth call (compiled launches always are);
        # untimed launches let the sample phase absorb the device wait.
        self.launch_timing_interval = max(int(launch_timing_interval), 1)
        self._launch_tick = 0
        self.metrics = Registry(max_series_per_family=max_series)
        self.tracer = Tracer(clock=self.clock, capacity=trace_capacity,
                             ring=trace_ring)
        self.requests = RequestTracker(self.metrics, self.tracer, self.clock)
        # the SLO flight recorder self-registers here (obs.tracing); when
        # set, record_step feeds it every step duration
        self.flight = None
        # model/arch geometry stamped into the latency-grid export so the
        # refit can rebuild cost-model scenarios for unobserved configs
        self._arch: dict = {}
        self._grid: dict[tuple, _LaunchStat] = {}
        self._useful_tokens = 0
        self._last_slots = 0

        m = self.metrics
        self._step_h = m.histogram(
            "repro_step_seconds", "Engine.step() wall-clock.",
            buckets=LATENCY_BUCKETS_S)
        self._phase_h = m.histogram(
            "repro_step_phase_seconds",
            "Wall-clock of one step phase (schedule/pack/launch/sample/"
            "host, plus `overlap`: host work for step N+1 done while "
            "step N's launch was still in flight — the async "
            "double-buffered loop).",
            labelnames=("phase",), buckets=LATENCY_BUCKETS_S)
        self._launch_h = m.histogram(
            "repro_launch_seconds",
            "Warm (post-capture) model-launch wall-clock by executable "
            "kind.", labelnames=("kind",), buckets=LATENCY_BUCKETS_S)
        self._compile_h = m.histogram(
            "repro_compile_seconds",
            "Launch wall-clock when a new executable was captured "
            "(trace+compile included).", labelnames=("kind",),
            buckets=LATENCY_BUCKETS_S)
        self._compile_c = m.counter(
            "repro_compile_events_total",
            "New executable captures by kind.", labelnames=("kind",))
        self._dispatch_c = m.counter(
            "repro_dispatch_total",
            "Kernel-config dispatch decisions by phase and chosen "
            "variant.", labelnames=("phase", "variant"))
        self._tokens_c = m.counter(
            "repro_tokens_total",
            "Token flow: prefill (computed), cached_prefill (skipped via "
            "prefix cache), sampled (output tokens).",
            labelnames=("kind",))
        self._slots_c = m.counter(
            "repro_launched_token_slots_total",
            "Token rows launched, including padding.")
        self._batch_tokens_h = m.histogram(
            "repro_step_batch_tokens",
            "Scheduled tokens per step (decodes + prefill chunks).",
            buckets=TOKEN_BUCKETS)
        self._padding_g = m.gauge(
            "repro_padding_waste_ratio",
            "Cumulative 1 - useful_tokens / launched_token_slots.")
        self._queue_g = m.gauge(
            "repro_queue_depth", "Requests by scheduler queue.",
            labelnames=("queue",))
        self._budget_g = m.gauge(
            "repro_budget_utilization",
            "Fraction of the per-step token budget scheduled.")
        self._pool_g = m.gauge(
            "repro_pool_pages", "KV page pool occupancy by page state.",
            labelnames=("state",))
        self._refs_g = m.gauge(
            "repro_pool_page_refs", "Total outstanding page references.")
        self._sched_c = m.counter(
            "repro_scheduler_events_total",
            "Scheduler events: admitted/preempted/finished/stalled/"
            "rejected.", labelnames=("event",))
        self._cache_c = m.counter(
            "repro_cache_events_total",
            "Prefix-cache lookups and evictions.", labelnames=("event",))
        self._cache_tok_c = m.counter(
            "repro_cache_hit_tokens_total",
            "Prompt tokens served from the prefix cache.")
        self._spec_c = m.counter(
            "repro_spec_tokens_total",
            "Speculative decoding token flow: proposed (drafted), "
            "accepted (verified == target), emitted (accepted + bonus).",
            labelnames=("kind",))
        self._spec_accept_g = m.gauge(
            "repro_spec_accept_rate",
            "Per-step draft acceptance rate (accepted / proposed; 0 when "
            "no drafts were scheduled).")
        self._steps_c = m.counter("repro_steps_total", "Engine steps run.")
        self._trace_dropped_g = m.gauge(
            "repro_trace_dropped_events",
            "Trace events dropped (bounded buffer) or overwritten (ring "
            "buffer) so far.")

    # -- arch geometry (for the refit loop) ----------------------------

    def set_arch(self, **kw) -> None:
        """Record model geometry (num_q_heads, num_kv_heads, head_dim,
        page_size) and the mesh shape (tp) for the latency-grid export —
        a grid recorded at one tp must refit only same-tp deployments."""
        self._arch.update(kw)

    # -- step phases ---------------------------------------------------

    def record_phase(self, name: str, t0: float, t1: float, **args) -> None:
        """One step region [t0, t1] (bounded by host waits on the card)."""
        self._phase_h.observe(t1 - t0, phase=name)
        self.tracer.complete(name, t0, t1, track="engine", **args)

    @contextmanager
    def phase(self, name: str, **args):
        t0 = self.clock.now()
        try:
            yield
        finally:
            self.record_phase(name, t0, self.clock.now(), **args)

    # -- launches ------------------------------------------------------

    def time_this_launch(self) -> bool:
        """Should the engine pay the synchronisation barrier for this
        launch?  True every `launch_timing_interval`-th call (sampled
        profiling); the engine additionally times every compiled launch."""
        self._launch_tick += 1
        return self._launch_tick % self.launch_timing_interval == 0

    def record_launch(self, kind: str, profile, kcfg, t0: float, t1: float,
                      *, compiled: bool, tokens: int,
                      grid_phase: str | None = None,
                      timed: bool = True,
                      cost: dict | None = None) -> None:
        """One model launch: `kind` is the executable-cache kind string,
        `profile`/`kcfg` the dispatch inputs/outputs (None when dispatch
        is disabled).  When `timed`, [t0, t1] brackets launch +
        its synchronisation and feeds the latency histograms/grid; untimed
        launches only count (their device wait lands in the sample
        phase).  `cost` optionally carries the executable's analytic cost
        (`{"flops", "bytes_accessed"}`, `Engine._exe_cost`), stamped onto the
        grid entry so the refit can separate host overhead from device
        time."""
        dt = t1 - t0
        if compiled:
            self._compile_c.inc(kind=kind)
        if timed:
            if compiled:
                self._compile_h.observe(dt, kind=kind)
            else:
                self._launch_h.observe(dt, kind=kind)
            self._phase_h.observe(dt, phase="launch")
        self.tracer.complete(f"launch:{kind}", t0, t1, track="engine",
                             tokens=tokens, compiled=compiled, timed=timed,
                             tp=self._arch.get("tp", 1))
        if compiled or not timed or profile is None or kcfg is None:
            return  # grid wants timed steady-state replay latency only
        key = (grid_phase or kind, dataclasses.astuple(profile),
               (kcfg.variant, kcfg.tile, kcfg.num_segments, kcfg.block_q))
        stat = self._grid.get(key)
        if stat is None:
            stat = self._grid[key] = _LaunchStat()
        stat.add(dt)
        if cost and stat.flops is None:
            # first-seen wins: one grid key can aggregate launches from
            # adjacent token buckets, whose costs differ only by padding
            stat.flops = float(cost.get("flops") or 0.0)
            stat.bytes = float(cost.get("bytes_accessed") or 0.0)

    def record_dispatch(self, phase: str, variant: str) -> None:
        self._dispatch_c.inc(phase=phase, variant=variant)

    # -- per-step rollup ----------------------------------------------

    def record_step(self, *, t0: float, t1: float, decision, stats: dict,
                    engine) -> None:
        """End-of-step rollup: latency, gauges, token-flow counters."""
        self._steps_c.inc()
        self._step_h.observe(t1 - t0)
        self.tracer.complete("step", t0, t1, track="engine",
                             step=engine.step_idx,
                             decode=stats["decode"],
                             prefill=stats["prefill"])
        sched = engine.sched
        self._queue_g.set(len(sched.waiting), queue="waiting")
        self._queue_g.set(len(sched.running), queue="running")
        self._budget_g.set(stats["budget_utilization"])
        pool = stats.get("pool") or engine.alloc.stats()
        for state in ("free_pages", "referenced_pages", "evictable_pages",
                      "shared_pages", "cached_pages"):
            self._pool_g.set(pool[state],
                             state=state.removesuffix("_pages"))
        self._refs_g.set(pool["total_refs"])

        n_dec = len(decision.decode_reqs)
        # the engine reports tokens it actually DELIVERED: under the
        # async double-buffered loop a scheduled row's sample may be
        # discarded (request finished/preempted while the launch was in
        # flight), so deriving the count from the decision over-counts
        sampled = stats.get("sampled_tokens")
        if sampled is None:
            sampled = n_dec + sum(1 for r in decision.prefill_reqs
                                  if r.prefill_done)
        self._tokens_c.inc(stats["prefill_tokens"], kind="prefill")
        self._tokens_c.inc(stats["cached_tokens"], kind="cached_prefill")
        self._tokens_c.inc(sampled, kind="sampled")
        proposed = stats.get("spec_proposed", 0)
        if proposed or stats.get("spec_emitted"):
            self._spec_c.inc(proposed, kind="proposed")
            self._spec_c.inc(stats.get("spec_accepted", 0), kind="accepted")
            self._spec_c.inc(stats.get("spec_emitted", 0), kind="emitted")
            self._spec_accept_g.set(
                stats.get("spec_accepted", 0) / proposed if proposed else 0.0)
        batch_tokens = n_dec + stats["prefill_tokens"]
        if batch_tokens:
            self._batch_tokens_h.observe(batch_tokens)
        self._useful_tokens += batch_tokens
        slots = engine.launched_token_slots
        self._slots_c.inc(slots - self._last_slots)
        self._last_slots = slots
        if slots:
            self._padding_g.set(1.0 - self._useful_tokens / slots)
        self._trace_dropped_g.set(self.tracer.dropped)
        if self.flight is not None:
            self.flight.observe_step(t1 - t0, step_idx=engine.step_idx)

    # -- scheduler / cache events -------------------------------------

    def scheduler_event(self, event: str, n: int = 1) -> None:
        if n:
            self._sched_c.inc(n, event=event)

    def cache_event(self, event: str, tokens: int = 0) -> None:
        self._cache_c.inc(event=event)
        if tokens:
            self._cache_tok_c.inc(tokens)

    # -- exports -------------------------------------------------------

    def grid_counts(self) -> dict[tuple, int]:
        """Warm-launch observation counts per (phase, profile) bucket —
        the refit daemon's watch signal for 'enough NEW observations'."""
        out: dict[tuple, int] = {}
        for (phase, prof, _cfg), st in list(self._grid.items()):
            key = (phase, prof)
            out[key] = out.get(key, 0) + st.count
        return out

    def latency_grid(self) -> dict:
        """Observed launch latencies keyed by (phase, profile, config) in
        the shape `autotune.tune.refit_from_telemetry` consumes."""
        entries = []
        # repr-key the sort: config tuples mix None and int tiles (e.g.
        # after a mid-run tree hot-swap), which tuple < cannot order
        for (phase, prof, cfg), st in sorted(list(self._grid.items()),
                                             key=lambda kv: repr(kv[0])):
            entries.append({
                "phase": phase,
                "profile": dict(zip(
                    ("num_seqs", "max_context", "group", "page_size",
                     "decode_share", "avg_query_len", "total_tokens",
                     "spec_tokens", "tp"),
                    prof)),
                "config": dict(zip(
                    ("variant", "tile", "num_segments", "block_q"), cfg)),
                "count": st.count,
                "total_s": st.total,
                "mean_s": st.total / st.count,
                "min_s": st.min,
                "max_s": st.max,
                "flops": st.flops,
                "bytes_accessed": st.bytes,
            })
        return {"version": 1, "arch": dict(self._arch), "entries": entries}

    def export_latency_grid(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.latency_grid(), f, indent=1)

    def prometheus_text(self) -> str:
        return self.metrics.render_prometheus()

    def export_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())

    def export_trace(self, path: str) -> None:
        self.tracer.export(path)

    def write_snapshot(self, path: str, **meta) -> None:
        self.metrics.write_jsonl(path, **meta)

    def summary(self) -> dict:
        """Request-lifecycle + step-latency digest (bench-friendly)."""
        out = self.requests.summary()
        out["step_p50"] = self._step_h.quantile(0.5)
        out["step_p95"] = self._step_h.quantile(0.95)
        out["padding_waste"] = self._padding_g.value()
        out["trace_dropped_events"] = self.tracer.dropped
        if self.flight is not None:
            out["slo_dumps"] = len(self.flight.dumps)
            out["slo_last_dump"] = (self.flight.dumps[-1]
                                    if self.flight.dumps else None)
        return out
