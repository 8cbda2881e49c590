"""Live scrape endpoint: a dependency-free HTTP server over `Telemetry`.

`MetricsServer` runs a stdlib `http.server.ThreadingHTTPServer` on a
background daemon thread and exposes the telemetry of a RUNNING engine —
no export-at-exit required:

* ``GET /metrics``  — Prometheus text exposition (v0.0.4), scrapeable by
  a stock Prometheus config.
* ``GET /snapshot`` — one JSON snapshot object (the same exact-round-trip
  shape `Registry.write_jsonl` appends per line).
* ``GET /trace``    — the Chrome/Perfetto trace JSON buffered so far.
* ``GET /healthz``  — liveness probe.

Binding ``port=0`` picks an ephemeral port (read it back from `.port`
after `start()`), so tests and multi-engine hosts never collide.

When built with ``snapshot_dir``, a second daemon thread appends one
JSONL snapshot line every ``snapshot_interval_s`` to
``snapshot_dir/metrics-<k>.jsonl``, rotating to a new file after
``snapshot_max_lines`` lines and pruning files beyond ``snapshot_keep``
— a long-running engine leaves a bounded on-disk metrics history even if
nobody scrapes it.

Thread-safety: handlers only *read* the registry/tracer through
materializing exports (see the design note in `obs.metrics`); the engine
thread remains the only writer.
"""
from __future__ import annotations

import http.server
import json
import logging
import os
import threading

log = logging.getLogger(__name__)


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        tel = self.server.telemetry
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = tel.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/snapshot":
                body = json.dumps(
                    {"meta": dict(self.server.meta),
                     "metrics": tel.metrics.snapshot()},
                    sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/trace":
                body = json.dumps(tel.tracer.to_json()).encode()
                ctype = "application/json"
            elif path in ("/", "/healthz"):
                body = b"ok: /metrics /snapshot /trace\n"
                ctype = "text/plain; charset=utf-8"
            else:
                self.send_error(404, "unknown path")
                return
        except Exception as e:  # noqa: BLE001 — a scrape must not kill serving
            log.exception("scrape handler failed for %s", path)
            self.send_error(500, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 (http.server API)
        log.debug("scrape %s — " + format, self.client_address[0], *args)


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """Background-thread scrape endpoint + periodic snapshot rotation."""

    def __init__(self, telemetry, *, host: str = "127.0.0.1", port: int = 0,
                 snapshot_dir: str | None = None,
                 snapshot_interval_s: float = 30.0,
                 snapshot_max_lines: int = 512, snapshot_keep: int = 4,
                 **meta):
        self.telemetry = telemetry
        self.host = host
        self._requested_port = port
        self.snapshot_dir = snapshot_dir
        self.snapshot_interval_s = float(snapshot_interval_s)
        self.snapshot_max_lines = max(int(snapshot_max_lines), 1)
        self.snapshot_keep = max(int(snapshot_keep), 1)
        self.meta = dict(meta)
        self._httpd: _Server | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._snap_lock = threading.Lock()
        self._snap_idx = 0
        self._snap_lines = 0
        self._snap_seq = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "MetricsServer":
        assert self._httpd is None, "already started"
        self._httpd = _Server((self.host, self._requested_port), _Handler)
        self._httpd.telemetry = self.telemetry
        self._httpd.meta = self.meta
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="repro-obs-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.snapshot_dir:
            t = threading.Thread(target=self._snapshot_loop,
                                 name="repro-obs-snapshot", daemon=True)
            t.start()
            self._threads.append(t)
        log.info("metrics endpoint live at %s (snapshots: %s)",
                 self.url("/metrics"), self.snapshot_dir or "off")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    @property
    def port(self) -> int:
        assert self._httpd is not None, "not started"
        return self._httpd.server_address[1]

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # -- snapshot rotation ---------------------------------------------

    def _snapshot_path(self) -> str:
        return os.path.join(self.snapshot_dir,
                            f"metrics-{self._snap_idx:04d}.jsonl")

    def snapshot_now(self, **extra) -> str:
        """Append one snapshot line, rotating/pruning as configured;
        returns the file written.  Also the snapshot thread's body, so
        tests can drive rotation deterministically."""
        assert self.snapshot_dir, "no snapshot_dir configured"
        with self._snap_lock:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            if self._snap_lines >= self.snapshot_max_lines:
                self._snap_idx += 1
                self._snap_lines = 0
                stale = self._snap_idx - self.snapshot_keep
                if stale >= 0:
                    old = os.path.join(self.snapshot_dir,
                                       f"metrics-{stale:04d}.jsonl")
                    if os.path.exists(old):
                        os.remove(old)
            path = self._snapshot_path()
            self.telemetry.write_snapshot(path, seq=self._snap_seq,
                                          **self.meta, **extra)
            self._snap_lines += 1
            self._snap_seq += 1
            return path

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.snapshot_interval_s):
            try:
                self.snapshot_now()
            except Exception:  # noqa: BLE001 — keep rotating
                log.exception("periodic snapshot failed")
