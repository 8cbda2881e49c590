"""Telemetry and the online refit on the port's engine, on the CPU
(reduced smollm-135m, fp32, weights carried over from the JAX package):

  * the port's engine and the JAX engine, each with a `FakeClock`
    `Telemetry(launch_timing_interval=1)`, on the same traces — packed
    with chunked prefill and prefix caching; the padded step; speculative
    decoding — give equal tokens and equal counters: steps, tokens by
    kind, scheduler and prefix-cache events, dispatch by (phase,
    variant), compile events by kind, launched slots, speculative token
    flow, the latency grid's keys and counts, and each request record's
    token, chunk and preemption counts.  (The JAX engine's XLA
    cost_analysis is stubbed out here: it costs a second compile of every
    executable and no counter reads it.)
  * the reference's tests/test_obs_serving.py, on the port: telemetry on
    and off give the same tokens and the telemetry agrees with the
    engine's ground truth; the exposition and the trace; every grid entry
    carries `flops` and `bytes_accessed`; the `RefitDaemon` hot-swaps
    token-identically with >= 1 refit and >= 1 swap; a forced mid-run
    swap reroutes dispatch and not tokens; `separate_host_overhead`
    reports its estimate; `max_prefill_tokens="auto"` takes a loaded
    tree's `suggested_max_prefill_tokens` as the JAX engine does;
  * `python -m repro_torch.launch.serve --device cpu --reduced
    --metrics-dir D --trace-out T` writes the metrics, the grid and the
    trace.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.attention import heuristics as jheur
from repro.models import model as JM
from repro.obs import FakeClock as JFakeClock, Telemetry as JTelemetry
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.autotune.tune import refit_from_telemetry
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.attention import heuristics as theur
from repro_torch.obs import FakeClock, RefitDaemon, Telemetry
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request

ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(max_seqs=4, num_pages=64, max_model_len=256)
CYCLE = [5, 9, 17, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the reduced model is tiny,
    and parallel test workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_trees():
    yield
    jheur.reset()
    theur.reset()


@pytest.fixture(scope="module")
def smollm():
    jcfg = jreduced(JARCHS["smollm-135m"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["smollm-135m"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in lens]


def _run(eng, request_cls, prompts, new):
    """Step `eng` over `prompts` to the end; (requests, per-step stats).
    Pages are conserved after every step and none leaks."""
    reqs = [request_cls(prompt=list(p), max_new_tokens=new)
            for p in prompts]
    for r in reqs:
        eng.add_request(r)
    stats = []
    while eng.sched.has_work:
        stats.append(eng.step())
        pool = eng.alloc.stats()
        assert pool["free_pages"] + pool["referenced_pages"] \
            + pool["evictable_pages"] == eng.num_pages - 1, pool
    assert all(r.done for r in reqs)
    return reqs, stats


def _keys(eng):
    """`compile_events` with each package's KernelConfig as a tuple."""
    return [k[:3] + (dataclasses.astuple(k[3]),) for k in eng.compile_events]


def _series(snap, name):
    fam = snap.get(name)
    return {} if fam is None else {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in fam["series"]}


def _counters(tel, reqs):
    """What the comparison holds equal between the two engines."""
    m = tel.metrics
    snap = m.snapshot()
    out = {name: _series(snap, f"repro_{name}") for name in (
        "tokens_total", "scheduler_events_total", "cache_events_total",
        "cache_hit_tokens_total", "dispatch_total", "compile_events_total",
        "spec_tokens_total", "request_events_total")}
    out["steps"] = m.value("repro_steps_total")
    out["slots"] = m.value("repro_launched_token_slots_total")
    out["grid"] = sorted(
        (e["phase"], tuple(e["profile"].items()),
         tuple(e["config"].items()), e["count"])
        for e in tel.latency_grid()["entries"])
    recs = tel.requests.records
    out["records"] = [(recs[r.req_id].num_tokens, recs[r.req_id].num_chunks,
                       recs[r.req_id].preemptions,
                       recs[r.req_id].prompt_tokens) for r in reqs]
    return out


TRACES = {
    # chunked prefill at 16 with prefix caching: a shared 32-token prefix
    # (two full pages), so later admissions hit the cache and resume
    "packed_chunked_cached": (
        lambda v: [CYCLE * 8 + q for q in _prompts(v, (5, 12, 20, 9, 14), 1)],
        6,
        dict(enable_chunked_prefill=True, max_prefill_tokens=16,
             enable_prefix_caching=True)),
    "padded": (lambda v: _prompts(v, (12, 7, 30), 5), 5,
               dict(packed_attention=False)),
    "speculative": (lambda v: [CYCLE * 6, (CYCLE * 5)[:18]]
                    + _prompts(v, (9,), 0), 10,
                    dict(speculative=True, draft_k=4)),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_counters_equal_the_jax_engine_s(smollm, monkeypatch, trace):
    jcfg, tcfg, params, model = smollm
    make, new, kw = TRACES[trace]
    prompts = make(tcfg.vocab_size)
    monkeypatch.setattr(JEngine, "_exe_cost", lambda self, *a: None)
    jtel = JTelemetry(clock=JFakeClock(tick=1e-4), launch_timing_interval=1)
    ttel = Telemetry(clock=FakeClock(tick=1e-4), launch_timing_interval=1)
    jeng = JEngine(jcfg, params, telemetry=jtel, **ENGINE, **kw)
    teng = Engine(tcfg, model, device="cpu", telemetry=ttel, **ENGINE, **kw)
    jreqs, _ = _run(jeng, JRequest, prompts, new)
    treqs, _ = _run(teng, Request, prompts, new)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert _keys(teng) == _keys(jeng)
    jc, tc = _counters(jtel, jreqs), _counters(ttel, treqs)
    for key in tc:
        assert tc[key] == jc[key], key
    assert tc["grid"], "no warm launch reached the grid"
    if trace == "packed_chunked_cached":
        assert tc["cache_hit_tokens_total"], "no prefix-cache hit"
    if trace == "speculative":
        assert tc["spec_tokens_total"], "no draft was proposed"


# ---------------------------------------------------------------------------
# the reference's tests/test_obs_serving.py on the port
# ---------------------------------------------------------------------------


def _engine(smollm, **kw):
    return Engine(smollm[1], smollm[3], device="cpu", **(ENGINE | kw))


def _assert_consistent(eng, reqs, stats):
    """The telemetry agrees with the engine's ground truth
    (serving_harness.assert_telemetry_consistent, on the port)."""
    tel = eng.telemetry
    m = tel.metrics
    total = lambda key: sum(s[key] for s in stats)  # noqa: E731
    assert m.value("repro_steps_total") == len(stats) == eng.step_idx
    assert m.value("repro_launched_token_slots_total") \
        == eng.launched_token_slots
    assert m.value("repro_tokens_total", kind="sampled") \
        == sum(len(r.output) for r in reqs)
    assert m.value("repro_tokens_total", kind="prefill") \
        == total("prefill_tokens") == eng.prefilled_tokens
    assert m.value("repro_tokens_total", kind="cached_prefill") \
        == total("cached_tokens") == eng.cached_prefill_tokens
    assert m.value("repro_scheduler_events_total", event="preempted") \
        == total("preempted")
    snap = m.snapshot()
    assert sum(_series(snap, "repro_compile_events_total").values()) \
        == len(eng.compile_events)
    for (phase, variant), n in eng.dispatch_counts.items():
        assert m.value("repro_dispatch_total", phase=phase,
                       variant=variant) == n
    recs = tel.requests.records
    assert len(recs) == len(reqs)
    for r in reqs:
        assert recs[r.req_id].num_tokens == len(r.output)
        assert recs[r.req_id].ttft is not None
    pool = eng.alloc.stats()
    for state in ("free", "referenced", "evictable", "shared", "cached"):
        assert m.value("repro_pool_pages", state=state) \
            == pool[f"{state}_pages"], state
    assert 0.0 <= m.value("repro_padding_waste_ratio") < 1.0
    names = [e["name"] for e in tel.tracer.to_json()["traceEvents"]]
    assert names.count("step") == len(stats)
    assert all(f"request {r.req_id}" in names for r in reqs)


@pytest.fixture(scope="module")
def chunked_run(smollm):
    """One chunked, prefix-cached trace with every launch timed, shared by
    the exposition, grid and refit tests."""
    tel = Telemetry(launch_timing_interval=1)
    eng = _engine(smollm, num_pages=96, enable_chunked_prefill=True,
                  enable_prefix_caching=True, max_prefill_tokens=16,
                  telemetry=tel)
    prompts = _prompts(smollm[1].vocab_size, (20, 11, 26, 9, 17), 7)
    reqs, stats = _run(eng, Request, prompts, 6)
    return eng, reqs, stats


def test_telemetry_consistent_and_exported(chunked_run, tmp_path):
    eng, reqs, stats = chunked_run
    _assert_consistent(eng, reqs, stats)
    tel = eng.telemetry
    text = tel.prometheus_text()
    for phase in ("schedule", "pack", "launch", "sample", "host"):
        assert f'repro_step_phase_seconds_bucket{{phase="{phase}"' in text
    assert 'repro_cache_events_total{event="' in text
    path = tmp_path / "trace.json"
    tel.export_trace(str(path))
    doc = json.loads(path.read_text())
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "thread_name"}
    assert "engine" in tracks and any(t.startswith("req-") for t in tracks)
    s = tel.summary()
    assert s["finished"] == len(reqs) and s["ttft_p50"] > 0


def test_latency_grid_carries_cost_and_refits(chunked_run, tmp_path):
    """Every warm launch in the grid carries the engine's analytic cost
    (`_exe_cost`); the grid refits into a tree `heuristics.load` takes,
    and `separate_host_overhead` reports and applies its estimate."""
    tel = chunked_run[0].telemetry
    grid = tel.latency_grid()
    assert any(e["phase"] == "unified" for e in grid["entries"])
    for e in grid["entries"]:
        assert e["count"] >= 1 and e["mean_s"] > 0
        assert e["flops"] > 0 and e["bytes_accessed"] > 0, e
    path = tmp_path / "grid.json"
    tel.export_latency_grid(str(path))
    rep = refit_from_telemetry(str(path), str(tmp_path / "refit.json"),
                               str(tmp_path / "refit.py"))
    st = rep["phases"]["unified"]
    assert st["profiles"] >= 1 and st["calibration_ratio"] > 0
    assert st["host_overhead_applied_s"] == 0.0
    theur.load(str(tmp_path / "refit.json"))
    assert theur.loaded_path() == str(tmp_path / "refit.json")
    sep = refit_from_telemetry(grid, str(tmp_path / "sep.json"),
                               separate_host_overhead=True)
    st2 = sep["phases"]["unified"]
    assert st2["host_overhead_s_est"] is not None \
        and st2["host_overhead_s_est"] >= 0
    assert 0.0 < st2["device_time_fraction"] <= 1.0
    assert st2["host_overhead_applied_s"] == st2["host_overhead_s_est"]
    assert st["host_overhead_s_est"] == st2["host_overhead_s_est"]


@pytest.mark.parametrize("packed", [True, False])
def test_telemetry_does_not_change_outputs(smollm, packed):
    prompts = _prompts(smollm[1].vocab_size, (14, 6, 21), 3)
    plain, _ = _run(_engine(smollm, packed_attention=packed), Request,
                    prompts, 5)
    eng = _engine(smollm, packed_attention=packed,
                  telemetry=Telemetry(clock=FakeClock(tick=1e-4)))
    observed, stats = _run(eng, Request, prompts, 5)
    assert [r.output for r in observed] == [r.output for r in plain]
    _assert_consistent(eng, observed, stats)
    kinds = {k for (k,), _ in
             _series(eng.telemetry.metrics.snapshot(),
                     "repro_compile_events_total").items()}
    assert kinds == ({("kind", "unified")} if packed
                     else {("kind", "prefill"), ("kind", "decode")})


def test_refit_daemon_hot_swaps_token_identically(smollm, tmp_path):
    """Watch -> refit -> hot-swap on the engine hook, under `run()` (the
    async loop): the tokens of an unobserved run, >= 1 refit and swap at
    step boundaries, the refit artifact, the swap counter and the trace
    instant."""
    prompts = _prompts(smollm[1].vocab_size, (18, 7, 24, 11), 9)

    def serve(**kw):
        eng = _engine(smollm, **kw)
        reqs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return eng, reqs

    _, plain = serve()
    tel = Telemetry(launch_timing_interval=1)
    daemon = RefitDaemon(tel, out_dir=str(tmp_path), min_new=3)
    eng, live = serve(telemetry=tel, refit=daemon)
    rep = daemon.report()
    assert rep["refits"] >= 1 and rep["swaps"] >= 1
    assert all(s is not None and s <= eng.step_idx
               for s in rep["swap_steps"])
    raw = json.loads((tmp_path / "refit-000.json").read_text())
    assert raw["unified_tree"]
    assert [r.output for r in live] == [r.output for r in plain]
    assert tel.metrics.value("repro_refit_swaps_total") == rep["swaps"]
    assert any(e["name"] == "heuristics_hot_swap"
               for e in tel.tracer.events())
    assert eng.last_step_stats["refit_swaps"] == rep["swaps"]
    with pytest.raises(ValueError, match="telemetry"):
        _engine(smollm, refit=RefitDaemon(Telemetry(), out_dir="."))


def test_forced_hot_swap_reroutes_dispatch_not_tokens(smollm):
    """A mid-run swap to a tree that routes every launch to the segmented
    variant splits dispatch between the two variants and changes no
    token; the new configuration's keys capture at their first use."""
    prompts = _prompts(smollm[1].vocab_size, (16, 8, 22), 13)
    plain, _ = _run(_engine(smollm), Request, prompts, 8)
    seg = {"variant": "segmented", "tile": None, "num_segments": 2,
           "block_q": 16}
    payload = {"decode_tree": [[{}, seg]], "prefill_tree": [[{}, seg]],
               "unified_tree": [[{}, seg]]}
    eng = _engine(smollm)
    reqs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
    for r in reqs:
        eng.add_request(r)
    steps = 0
    while eng.sched.has_work:
        if steps == 4:  # a step boundary: the daemon's swap point
            theur.load_payload(payload, source="<forced>")
        eng.step()
        steps += 1
    variants = {v for (ph, v) in eng.dispatch_counts if ph == "unified"}
    assert variants == {"gqa", "segmented"}, dict(eng.dispatch_counts)
    assert [r.output for r in reqs] == [r.output for r in plain]
    assert any(k[3].num_segments == 2 for k in eng.compile_events)


@pytest.mark.parametrize("chunked", [True, False])
def test_auto_chunk_budget_follows_a_loaded_tree(smollm, tmp_path,
                                                 chunked):
    """`max_prefill_tokens="auto"` takes a loaded tree's exported budget
    exactly as the JAX engine does with the same JSON (unchunked, any
    prompt that fits a sequence is admitted); without a tree the port's
    budget comes from its own (Hopper) cost model."""
    jcfg, tcfg, params, model = smollm
    tree = {"decode_tree": [[{}, {"variant": "gqa", "tile": None,
                                  "num_segments": 8, "block_q": 16}]],
            "suggested_max_prefill_tokens": 48}
    path = tmp_path / "tree.json"
    path.write_text(json.dumps(tree))
    jheur.load(str(path))
    theur.load(str(path))
    kw = dict(ENGINE, max_prefill_tokens="auto",
              enable_chunked_prefill=chunked)
    jeng = JEngine(jcfg, params, **kw)
    teng = Engine(tcfg, model, device="cpu", **kw)
    assert teng.max_prefill_tokens == jeng.max_prefill_tokens \
        == (48 if chunked else 256)
    assert teng.sched.max_prefill_tokens == teng.max_prefill_tokens
    theur.reset()
    from repro_torch.autotune.costmodel import suggest_max_prefill_tokens
    own = Engine(tcfg, model, device="cpu", **kw)
    assert own.max_prefill_tokens == (suggest_max_prefill_tokens(
        num_q_heads=tcfg.num_q_heads, num_kv_heads=tcfg.num_kv_heads,
        head_dim=tcfg.resolved_head_dim, page_size=tcfg.page_size,
        max_seqs=4, target_context=256) if chunked else 256)
    prompts = _prompts(tcfg.vocab_size, (40, 9), 2)
    reqs, _ = _run(own, Request, prompts, 3)
    assert all(len(r.output) == 3 for r in reqs)


def test_serve_writes_metrics_and_trace(tmp_path):
    mdir, trace = tmp_path / "m", tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--num-requests",
         "3", "--max-seqs", "2", "--max-new-tokens", "4", "--max-prompt",
         "30", "--metrics-dir", str(mdir), "--trace-out", str(trace)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    for name in ("metrics.prom", "metrics.jsonl", "latency_grid.json"):
        assert (mdir / name).exists(), name
    assert "repro_steps_total" in (mdir / "metrics.prom").read_text()
    grid = json.loads((mdir / "latency_grid.json").read_text())
    assert grid["arch"]["page_size"] == 16
    doc = json.loads(trace.read_text())
    assert any(e["name"] == "step" for e in doc["traceEvents"])
    assert "telemetry: ttft p50" in out.stdout
