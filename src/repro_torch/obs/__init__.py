"""Observability: metrics registry, step/request tracing, and the
telemetry→autotune refit loop's latency-grid export.

A copy of `repro.obs` (stdlib only, so the serving stack can always
import it); the metric names, trace events and latency-grid schema are
the reference's, documented in docs/observability.md.
"""
from .clock import Clock, FakeClock, PerfCounterClock
from .metrics import (
    LATENCY_BUCKETS_S, TOKEN_BUCKETS, Counter, Gauge, Histogram, Registry,
    parse_prometheus, pow2_buckets,
)
from .refit import RefitDaemon
from .server import MetricsServer
from .telemetry import Telemetry
from .tracing import FlightRecorder, RequestRecord, RequestTracker, Tracer

__all__ = [
    "Clock", "FakeClock", "PerfCounterClock",
    "Counter", "Gauge", "Histogram", "Registry", "pow2_buckets",
    "parse_prometheus",
    "LATENCY_BUCKETS_S", "TOKEN_BUCKETS",
    "Tracer", "RequestTracker", "RequestRecord", "FlightRecorder",
    "MetricsServer", "RefitDaemon",
    "Telemetry",
]
