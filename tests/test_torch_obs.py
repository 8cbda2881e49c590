"""The port's observability copy (`repro_torch.obs`) against the reference
(`repro.obs`): the same call sequences, on a `FakeClock` each, give the
same Prometheus text, snapshot, trace JSON, request summaries and latency
grid (the grid's profiles and configs are each package's own
`BatchProfile` / `KernelConfig`), so a scrape, a trace or a grid of either
package reads the same; `parse_prometheus` round-trips the port's
exposition; the port's `MetricsServer` answers on an ephemeral port; the
SLO flight recorder dumps the same trace ring."""
import json
import os
import types
import urllib.error
import urllib.request

import pytest

from repro import obs as jobs
from repro.core.attention import heuristics as jheur
from repro_torch import obs as tobs
from repro_torch.core.attention import heuristics as theur

PACKAGES = {"reference": (jobs, jheur), "port": (tobs, theur)}


def _registry_calls(obs):
    r = obs.Registry(max_series_per_family=4)
    c = r.counter("repro_x_total", "A counter.", labelnames=("kind",))
    g = r.gauge("repro_g", 'A gauge with "quotes" and a \\ slash.')
    h = r.histogram("repro_h_seconds", "A histogram.", labelnames=("k",),
                    buckets=obs.pow2_buckets(1e-3, 1.0))
    for i in range(7):
        c.inc(i + 0.5, kind=f"k{i % 5}")  # the fifth label value overflows
        g.set(i * 1.25)
        h.observe(10.0 ** -(i % 4), k="a" if i % 2 else "b")
    return r


def test_registry_exposition_identical():
    out = {}
    for name, (obs, _) in PACKAGES.items():
        r = _registry_calls(obs)
        out[name] = (r.render_prometheus(), r.snapshot(),
                     r.value("repro_x_total", kind="k1"))
    assert out["port"] == out["reference"]


@pytest.mark.parametrize("ring", [False, True])
def test_tracer_json_identical(ring):
    docs = {}
    for name, (obs, _) in PACKAGES.items():
        tr = obs.Tracer(clock=obs.FakeClock(tick=0.25), capacity=8,
                        ring=ring)
        for i in range(6):
            t0 = tr.clock.now()
            tr.complete(f"span{i}", t0, tr.clock.now(), track="engine",
                        step=i)
            tr.instant("mark", track=f"req-{i % 2}", i=i)
        with tr.span("ctx", track="engine", a=1):
            pass
        docs[name] = (tr.to_json(), tr.dropped, len(tr.events()))
    assert docs["port"] == docs["reference"]


def _lifecycle(obs):
    clock = obs.FakeClock(tick=0.01)
    reg = obs.Registry()
    rt = obs.RequestTracker(reg, obs.Tracer(clock=clock), clock)
    reqs = [types.SimpleNamespace(req_id=i, prompt=[1] * (5 + i))
            for i in range(3)]
    for r in reqs:
        rt.submit(r)
    clock.advance(0.5)
    rt.chunk(reqs[0])
    rt.token(reqs[0])
    rt.token(reqs[1])  # admitted straight to decode
    rt.preempt(reqs[0])
    clock.advance(0.2)
    rt.chunk(reqs[0])
    for _ in range(3):
        for r in reqs:
            rt.token(r)
    for r in reqs:
        rt.finish(r)
    return rt, reg


def test_request_tracker_identical():
    out = {}
    for name, (obs, _) in PACKAGES.items():
        rt, reg = _lifecycle(obs)
        out[name] = (rt.summary(), reg.render_prometheus(),
                     rt.tracer.to_json(),
                     {k: (r.ttft, r.num_tokens, r.preemptions, r.queue_time)
                      for k, r in rt.records.items()})
    assert out["port"] == out["reference"]


def _drive_telemetry(obs, heur, tmp_path):
    """One fixed sequence of every hook the engine, scheduler and prefix
    cache call, on a FakeClock."""
    tel = obs.Telemetry(clock=obs.FakeClock(tick=1e-4),
                        launch_timing_interval=2)
    tel.set_arch(num_q_heads=9, num_kv_heads=3, head_dim=64, page_size=16,
                 tp=1)
    reqs = [types.SimpleNamespace(req_id=i, prompt=[1] * 20,
                                  prefill_done=bool(i % 2))
            for i in range(3)]
    for r in reqs:
        tel.requests.submit(r)
    pool = {"free_pages": 10, "referenced_pages": 3, "evictable_pages": 1,
            "shared_pages": 0, "cached_pages": 2, "total_refs": 4}
    engine = types.SimpleNamespace(
        step_idx=0, sched=types.SimpleNamespace(waiting=[1], running=reqs),
        alloc=types.SimpleNamespace(stats=lambda: pool),
        launched_token_slots=0)
    cfgs = [heur.KernelConfig("gqa"), heur.KernelConfig("segmented", tile=8,
                                                        num_segments=4)]
    for step in range(6):
        t0 = tel.clock.now()
        with tel.phase("schedule", decode=1):
            tel.scheduler_event("admitted", n=step % 2)
        prof = heur.BatchProfile(
            num_seqs=1 + step % 3, max_context=64 << (step % 2), group=3,
            page_size=16, decode_share=0.5, avg_query_len=8,
            total_tokens=32, spec_tokens=4 * (step % 2))
        kcfg = cfgs[step % 2]
        tel.record_dispatch("unified", kcfg.variant)
        timed = step < 2 or tel.time_this_launch()
        tl = tel.clock.now()
        tel.record_launch("unified", prof, kcfg, tl, tel.clock.now(),
                          compiled=step < 2, tokens=32, grid_phase="unified",
                          timed=timed,
                          cost={"flops": 1e9 * step,
                                "bytes_accessed": 2e6})
        tel.cache_event("hit" if step % 2 else "miss", tokens=16 * step)
        for r in reqs[: 1 + step % 3]:
            tel.requests.token(r)
        engine.step_idx = step
        engine.launched_token_slots += 40
        stats = {"decode": 1, "prefill": 1, "budget_utilization": 0.5,
                 "prefill_tokens": 7, "cached_tokens": step,
                 "sampled_tokens": 2, "spec_proposed": step,
                 "spec_accepted": step // 2, "spec_emitted": step}
        decision = types.SimpleNamespace(decode_reqs=reqs[:1],
                                         prefill_reqs=reqs[1:])
        tel.record_step(t0=t0, t1=tel.clock.now(), decision=decision,
                        stats=stats, engine=engine)
    for r in reqs:
        tel.requests.finish(r)
    tel.tracer.instant("heuristics_hot_swap", track="engine", path="x",
                       step=3)
    path = tmp_path / f"{obs.__name__}.jsonl"
    tel.write_snapshot(str(path), arch="smollm-135m")
    snap = [json.loads(line) for line in open(path)]
    return tel, snap


def test_telemetry_identical(tmp_path):
    out = {}
    for name, (obs, heur) in PACKAGES.items():
        tel, snap = _drive_telemetry(obs, heur, tmp_path)
        out[name] = dict(
            text=tel.prometheus_text(), snapshot=snap,
            trace=tel.tracer.to_json(), grid=tel.latency_grid(),
            counts=tel.grid_counts(), summary=tel.summary())
    for key in out["port"]:
        assert out["port"][key] == out["reference"][key], key
    grid = out["port"]["grid"]
    assert grid["arch"]["page_size"] == 16 and len(grid["entries"]) >= 2
    assert all(e["flops"] is not None for e in grid["entries"])


def test_parse_prometheus_round_trips(tmp_path):
    tel, _ = _drive_telemetry(tobs, theur, tmp_path)
    text = tel.prometheus_text()
    parsed = tobs.parse_prometheus(text)
    assert parsed == jobs.parse_prometheus(text)
    snap = tel.metrics.snapshot()
    assert set(snap) <= set(parsed)
    for fam, body in snap.items():
        assert parsed[fam]["type"] == body["type"], fam
        if body["type"] in ("counter", "gauge"):
            got = {tuple(sorted(labels.items())): v
                   for _, labels, v in parsed[fam]["samples"]}
            for series in body["series"]:
                key = tuple(sorted(series["labels"].items()))
                assert got[key] == series["value"], (fam, key)
    [(_, _, steps)] = parsed["repro_steps_total"]["samples"]
    assert steps == 6


def test_metrics_server_answers_on_an_ephemeral_port(tmp_path):
    tel, _ = _drive_telemetry(tobs, theur, tmp_path)
    server = tobs.MetricsServer(tel, port=0, snapshot_dir=str(tmp_path),
                                arch="smollm-135m").start()
    try:
        assert server.port > 0

        def get(path):
            with urllib.request.urlopen(server.url(path), timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read()

        status, ctype, body = get("/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert body.decode() == tel.prometheus_text()
        snap = json.loads(get("/snapshot")[2])
        assert snap["meta"] == {"arch": "smollm-135m"}
        assert snap["metrics"] == json.loads(json.dumps(
            tel.metrics.snapshot(), sort_keys=True))
        trace = json.loads(get("/trace")[2])
        assert any(e["name"] == "heuristics_hot_swap"
                   for e in trace["traceEvents"])
        assert get("/healthz")[0] == 200
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
        written = server.snapshot_now()
        assert os.path.exists(written)
    finally:
        server.stop()


def test_flight_recorder_dumps_identically(tmp_path):
    out = {}
    for name, (obs, _) in PACKAGES.items():
        tel = obs.Telemetry(clock=obs.FakeClock(tick=1e-3), trace_ring=True,
                            trace_capacity=64)
        d = tmp_path / name
        rec = obs.FlightRecorder(tel, slo_p95_s=0.05, dump_dir=str(d),
                                 window=8, min_steps=4)
        for i in range(12):
            dt = 0.1 if 4 <= i < 8 else 0.01
            rec.observe_step(dt, step_idx=i)
        out[name] = (len(rec.dumps), rec.rolling_p95(),
                     sorted(os.listdir(d)))
    assert out["port"] == out["reference"]
    assert out["port"][0] >= 1
