"""Online refit daemon: watch the latency grid, refit, hot-swap.

Closes the telemetry→autotune loop *while the engine is serving* instead
of offline (`python -m repro_torch.launch.autotune --refit-from`).  Lifecycle:

1. **watch** — every step (or every `poll_interval_s` when `start()`ed
   as a background thread) compare `Telemetry.grid_counts()` against the
   counts at the last refit; the trigger is *new* warm observations:
   at least `min_keys` (phase, profile-bucket) keys must each have
   accumulated `min_new` new timed launches, so a refit always sees
   fresh steady-state data, never the same grid twice.
2. **refit** — `tune.refit_from_telemetry` on the live grid; the
   resulting `heuristics.load`-compatible payload is written to
   `out_dir/refit-<k>.json` (an auditable artifact, same as the offline
   path) and parked as *pending*.
3. **hot-swap** — the ENGINE thread applies the pending payload between
   steps via `heuristics.load()` (`Engine(..., refit=daemon)` calls
   `on_step` after every finished step).  Dispatch re-reads the trees at
   every step's pack, so the swap changes only which `KernelConfig` the
   next steps route to — never the tokens: configs key mathematically
   equivalent executables (the per-config bit-identity the kernel suites
   assert), which is the differential guard `tests/test_obs_serving.py`
   re-proves end to end.

The compute half (steps 1–2) may run inline on the engine thread
(default: triggered from `on_step`) or on a daemon thread (`start()`);
either way the swap itself only ever happens on the engine thread at a
step boundary, so a step never sees two trees.
"""
from __future__ import annotations

import logging
import os
import threading

from repro_torch.core.attention import heuristics

log = logging.getLogger(__name__)


class RefitDaemon:
    def __init__(self, telemetry, *, out_dir: str, min_new: int = 64,
                 min_keys: int = 1, poll_interval_s: float = 5.0,
                 refit_kw: dict | None = None):
        self.telemetry = telemetry
        self.out_dir = out_dir
        self.min_new = max(int(min_new), 1)
        self.min_keys = max(int(min_keys), 1)
        self.poll_interval_s = float(poll_interval_s)
        self.refit_kw = dict(refit_kw or {})
        self.refits = 0  # payloads computed
        self.swaps = 0  # payloads hot-swapped in by the engine
        self.swap_steps: list[int | None] = []
        self.last_path: str | None = None
        self.last_report: dict | None = None
        self._baseline: dict[tuple, int] = {}
        self._pending: str | None = None
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        m = telemetry.metrics
        self._refit_c = m.counter(
            "repro_refit_total",
            "Online heuristics refits computed from the latency grid.")
        self._swap_c = m.counter(
            "repro_refit_swaps_total",
            "Refit heuristics trees hot-swapped in between steps.")

    # -- watch ---------------------------------------------------------

    def new_counts(self) -> dict[tuple, int]:
        """New warm observations per (phase, profile) since last refit."""
        cur = self.telemetry.grid_counts()
        return {k: n - self._baseline.get(k, 0) for k, n in cur.items()
                if n - self._baseline.get(k, 0) > 0}

    def should_refit(self) -> bool:
        ready = sum(1 for n in self.new_counts().values()
                    if n >= self.min_new)
        return ready >= self.min_keys

    # -- refit ---------------------------------------------------------

    def refit_now(self) -> str:
        """Refit from the live grid; park the payload for the engine to
        swap in at the next step boundary."""
        # deferred import: obs stays importable without torch/numpy, and
        # the autotune stack only loads once a refit actually fires
        from repro_torch.autotune.tune import refit_from_telemetry
        grid = self.telemetry.latency_grid()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"refit-{self.refits:03d}.json")
        report = refit_from_telemetry(grid, path, **self.refit_kw)
        baseline: dict[tuple, int] = {}
        for e in grid["entries"]:
            key = (e["phase"], tuple(e["profile"].values()))
            baseline[key] = baseline.get(key, 0) + e["count"]
        with self._lock:
            self._baseline = baseline
            self._pending = path
            self.last_report = report
        self.refits += 1
        self._refit_c.inc()
        log.info("online refit #%d -> %s (phases: %s)", self.refits, path,
                 ", ".join(sorted(report["phases"])))
        return path

    def maybe_refit(self) -> str | None:
        return self.refit_now() if self.should_refit() else None

    # -- hot-swap (engine thread, between steps) -----------------------

    def apply_pending(self, engine=None) -> bool:
        with self._lock:
            path, self._pending = self._pending, None
        if path is None:
            return False
        heuristics.load(path)
        self.swaps += 1
        self.swap_steps.append(getattr(engine, "step_idx", None))
        self.last_path = path
        self._swap_c.inc()
        self.telemetry.tracer.instant(
            "heuristics_hot_swap", track="engine", path=path,
            step=getattr(engine, "step_idx", None))
        return True

    def on_step(self, engine=None) -> None:
        """Engine hook after every finished step: when no background
        thread owns the watch, evaluate the trigger inline; then swap in
        any pending tree — we ARE at a step boundary, so an inline refit
        applies immediately."""
        if self._thread is None:
            self.maybe_refit()
        self.apply_pending(engine)

    # -- background mode -----------------------------------------------

    def start(self) -> "RefitDaemon":
        """Move watch+refit to a daemon thread; the engine's `on_step`
        keeps applying pending swaps at step boundaries."""
        assert self._thread is None, "already started"
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-obs-refit", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.maybe_refit()
            except Exception:  # noqa: BLE001 — keep serving on refit failure
                log.exception("online refit failed")

    def report(self) -> dict:
        return {"refits": self.refits, "swaps": self.swaps,
                "swap_steps": list(self.swap_steps),
                "last_path": self.last_path}
