"""The port's async double-buffered drive loop (`submit()` / `stream()` /
`run()`) on the CPU, against the JAX package's and against the port's own
synchronous `generate()` (reduced models, fp32, weights carried over by
`weights.from_jax_params`):

  * `stream()` on the packed step yields the JAX engine's `stream()`
    pairs token for token, in the same order, with the same steps (greedy;
    chunked prefill; a 13-page trace that preempts requests while their
    tokens are in flight);
  * a sampled request gives the same tokens through `stream()` as through
    `generate()` (the draw counter counts an in-flight placeholder; the
    port's noise bits differ from JAX's threefry by design, so sampled
    tokens are compared within the port);
  * the reference's async tests, mirrored: EOS sampled by a
    prompt-completing chunk, `run()`'s outputs and callbacks, one device
    call per async packed step, `max_steps` exhaustion;
  * the padded step under `stream()` steps synchronously and equals
    `generate()` (zamba2, xlstm, smollm with `packed_attention=False`);
  * the bookkeeping of the two host buffers the sampled ids leave the
    card through (`TokenCopies`), and the entries' device inputs;
  * `launch.serve --stream` on the CPU.
"""
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.serving import cuda_graphs
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import PENDING_TOKEN, Request, State

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 6
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20)


def _build(arch):
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models are tiny: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smollm():
    return _build("smollm-135m")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in lens]


def _engine(built, **kw):
    _, tcfg, _, model = built
    return TEngine(tcfg, model, device="cpu",
                   **(dict(max_seqs=4, num_pages=64, max_model_len=256) | kw))


def _streamed(eng, reqs, **kw):
    """Submit `reqs`, drain `stream()`; the yields as (request index,
    token) pairs in order."""
    index = {eng.submit(r): i for i, r in enumerate(reqs)}
    return [(index[rid], tok) for rid, tok in eng.stream(**kw)]


def _assert_no_leak(eng, reqs):
    assert all(r.state is State.FINISHED for r in reqs)
    assert all(not r._placeholder and PENDING_TOKEN not in r.output
               for r in reqs)
    assert eng.alloc.free_pages == eng.num_pages - 1, "pages leaked"


# ---------------------------------------------------------------------------
# stream() against the JAX engine's stream()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", ["chunked", "preempting"])
def test_stream_matches_reference_stream(smollm, trace):
    """Greedy, packed: the port's double-buffered `stream()` yields the
    JAX engine's (request, token) pairs in the same order over the same
    number of steps, with the same launched token rows and dispatch.
    "chunked": a 32-token budget splits the long prompts into resumed
    chunks; "preempting": 13 pages of 16 for four requests that need ~18,
    so decoding requests are preempted while a token of theirs is in
    flight (the epoch discards it) and resumed."""
    jcfg, _, params, _ = smollm
    if trace == "chunked":
        kw = dict(enable_chunked_prefill=True, max_prefill_tokens=32)
        lens, new, seed = (90, 12, 47, 5, 33), MAX_NEW, 1
    else:
        kw = dict(num_pages=13, max_model_len=128)
        lens, new, seed = (40, 33, 47, 20), 24, 7
    prompts = _prompts(jcfg.vocab_size, lens, seed)
    jeng = JEngine(jcfg, params,
                   **(dict(max_seqs=4, num_pages=64, max_model_len=256) | kw))
    jreqs = [JRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    teng = _engine(smollm, **kw)
    treqs = [Request(prompt=list(p), max_new_tokens=new) for p in prompts]
    want = _streamed(jeng, jreqs)
    got = _streamed(teng, treqs)
    assert got == want
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.prompt for r in treqs] == [r.prompt for r in jreqs]
    assert teng.step_idx == jeng.step_idx
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    assert teng.last_generate == jeng.last_generate
    _assert_no_leak(teng, treqs)
    if trace == "preempting":
        assert any(len(r.prompt) > n for r, n in zip(treqs, lens)), \
            "no request was preempted"


# ---------------------------------------------------------------------------
# sampled requests: stream() against generate()
# ---------------------------------------------------------------------------


def _sampled(prompts, **kw):
    return [Request(prompt=list(p), max_new_tokens=MAX_NEW, seed=100 + i,
                    **(SAMPLED if i % 2 == 0 else {}), **kw)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("pressure", [False, True])
def test_stream_sampled_matches_generate(smollm, pressure):
    """Sampled (even) and greedy (odd) requests, seeds pinned: `stream()`
    gives exactly `generate()`'s tokens.  The async launch that reads a
    token still in flight draws its noise at num_generated + 1, as the
    synchronous step after it would.  With `pressure`, 14 pages and two
    slots preempt requests (their in-flight tokens are discarded and
    redrawn from the same stream positions): the outputs still equal the
    roomy synchronous run's."""
    prompts = _prompts(smollm[1].vocab_size, (30, 28, 26, 24, 9), 5)
    sync = _sampled(prompts)
    _engine(smollm).generate(sync)
    eng = _engine(smollm, **(dict(num_pages=14, max_seqs=2) if pressure
                             else {}))
    reqs = _sampled(prompts)
    pairs = _streamed(eng, reqs)
    assert [r.output for r in reqs] == [r.output for r in sync]
    for i, r in enumerate(reqs):  # the yields ARE the outputs, in order
        assert [t for j, t in pairs if j == i] == r.output
    _assert_no_leak(eng, reqs)


def test_stream_carries_placeholders_and_epochs(smollm):
    """Inside the loop: after a step is dispatched behind one in flight,
    each request with a row in the flight holds one PENDING_TOKEN
    placeholder and its decode row reads its input on the card
    (token_source); `_finish_step` fills it.  A request preempted while
    its tokens are in flight drops the placeholder and bumps its epoch:
    both launches' rows of it are discarded, and the run still ends with
    `generate()`'s tokens."""
    prompts = _prompts(smollm[1].vocab_size, (9, 17), 3)
    sync = [Request(prompt=list(p), max_new_tokens=4) for p in prompts]
    _engine(smollm).generate(sync)
    eng = _engine(smollm)
    reqs = [Request(prompt=list(p), max_new_tokens=4) for p in prompts]
    for r in reqs:
        eng.submit(r)
    first = eng._begin_step(None)  # the prefill, nothing in flight
    assert not any(r._placeholder for r in reqs)
    second = eng._begin_step(first)  # decodes behind it
    assert all(r._placeholder and r.output == [PENDING_TOKEN] for r in reqs)
    assert sorted(r.req_id for r, _, _ in second.pack.rows) == \
        sorted(r.req_id for r in reqs)
    victim = reqs[1]
    eng.sched._preempt(victim)  # while both launches are in flight
    assert not victim._placeholder and victim.output == []
    assert victim._spec_epoch == 1
    eng._finish_step(first)
    assert len(reqs[0].output) == 1 and not reqs[0]._placeholder
    assert reqs[0].output[0] != PENDING_TOKEN
    assert victim.output == [] and victim.num_generated == 0
    eng._finish_step(second)
    assert len(reqs[0].output) == 2 and victim.output == []
    for _ in eng.stream():
        pass
    assert [r.output for r in reqs] == [r.output for r in sync]
    _assert_no_leak(eng, reqs)


# ---------------------------------------------------------------------------
# the reference's async tests (tests/test_fused_sampling.py), mirrored
# ---------------------------------------------------------------------------


def test_async_packed_step_is_one_device_call(smollm):
    """A steady async packed step adds exactly {"unified": 1} device calls
    and no compile event (tests/test_fused_sampling.py:86, under the
    async loop)."""
    eng = _engine(smollm)
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW)
            for p in _prompts(smollm[1].vocab_size, (5, 40, 17), 0)]
    for r in reqs:
        eng.submit(r)
    flights = [eng._begin_step(None)]
    flights.append(eng._begin_step(flights[0]))  # the decode key's capture
    eng._finish_step(flights[0])
    before, events = dict(eng.device_calls), len(eng.compile_events)
    nxt = eng._begin_step(flights[1])
    st = eng._finish_step(flights[1])
    assert st["decode"] == len(reqs) and st["prefill"] == 0
    after = dict(eng.device_calls)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {"unified": 1}
    assert len(eng.compile_events) == events, "steady step recompiled"
    eng._finish_step(nxt)
    for _ in eng.stream():
        pass
    assert set(eng.device_calls) == {"unified"}
    _assert_no_leak(eng, reqs)


def test_stream_eos_on_prompt_completing_chunk(smollm):
    """EOS sampled by a prompt-completing chunk under chunked prefill: the
    request finishes (one step late) with exactly that token, without
    corrupting the others or leaking pages
    (tests/test_fused_sampling.py:271)."""
    prompts = _prompts(smollm[1].vocab_size, (24, 17, 6), 3)
    probe = [Request(prompt=list(p), max_new_tokens=1) for p in prompts]
    _engine(smollm).generate(probe)
    first = [r.output[0] for r in probe]
    base = [Request(prompt=list(p), max_new_tokens=MAX_NEW) for p in prompts]
    _engine(smollm).generate(base)
    for i, eos in enumerate(first):
        eng = _engine(smollm, enable_chunked_prefill=True,
                      max_prefill_tokens=8)
        reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW,
                        eos_token=eos if j == i else None)
                for j, p in enumerate(prompts)]
        pairs = _streamed(eng, reqs)
        assert reqs[i].output == [eos], (i, reqs[i].output)
        assert [t for j, t in pairs if j == i] == [eos]
        for j, r in enumerate(reqs):
            if j != i:  # the others run on unaffected
                want = base[j].output
                if eos in want:
                    want = want[:want.index(eos) + 1]
                assert r.output == want
        _assert_no_leak(eng, reqs)


def test_run_drive_loop_and_callbacks(smollm):
    """`run()`: every submitted request finishes once through
    `on_finish`, `on_token` sees each token in order, the outputs equal
    `generate()`'s, and the callback is uninstalled after
    (tests/test_fused_sampling.py:317)."""
    prompts = _prompts(smollm[1].vocab_size, (5, 40, 17, 70, 3, 33), 0)
    sync = [Request(prompt=list(p), max_new_tokens=MAX_NEW) for p in prompts]
    _engine(smollm).generate(sync)
    eng = _engine(smollm)
    reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW) for p in prompts]
    ids = [eng.submit(r) for r in reqs]
    seen: list[tuple[int, int]] = []
    finished: list[int] = []
    out = eng.run(on_token=lambda rid, tok: seen.append((rid, tok)),
                  on_finish=lambda req: finished.append(req.req_id))
    assert sorted(finished) == sorted(ids)
    assert out["unfinished"] == 0 and not out["exhausted"]
    for r, s in zip(reqs, sync):
        assert out["outputs"][r.req_id] == r.output == s.output
        assert [t for rid, t in seen if rid == r.req_id] == r.output
    assert eng.sched.on_finish is None
    _assert_no_leak(eng, reqs)


@pytest.mark.parametrize("api", ["generate", "stream"])
def test_max_steps_exhaustion_warns(smollm, caplog, api):
    """A drive loop cut by `max_steps` with requests unfinished warns and
    says so in `last_generate`; a completing run reports clean
    (tests/test_fused_sampling.py:338)."""
    prompts = _prompts(smollm[1].vocab_size, (5, 40, 17), 0)
    eng = _engine(smollm)
    reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW) for p in prompts]
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.serving.engine"):
        if api == "generate":
            eng.generate(reqs, max_steps=2)
        else:
            for r in reqs:
                eng.submit(r)
            list(eng.stream(max_steps=2))
    assert eng.last_generate["steps"] == 2
    assert eng.last_generate["exhausted"]
    assert eng.last_generate["unfinished"] == len(
        [r for r in reqs if r.state is not State.FINISHED]) > 0
    assert any("max_steps" in rec.message and api in rec.message
               for rec in caplog.records)
    assert not any(r._placeholder for r in reqs), "a token left in flight"
    eng2 = _engine(smollm)
    eng2.submit(Request(prompt=list(prompts[0]), max_new_tokens=2))
    list(eng2.stream()) if api == "stream" else eng2.generate([])
    assert not eng2.last_generate["exhausted"]
    assert eng2.last_generate["unfinished"] == 0


# ---------------------------------------------------------------------------
# the padded step under stream()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m", "smollm-135m"])
def test_padded_stream_matches_generate(arch):
    """The padded per-kind step (zamba2, xlstm; smollm with
    `packed_attention=False`) steps synchronously under `stream()`: the
    same tokens as `generate()` (a sampled request among greedy ones), the
    yields the outputs in order, the same steps.  Its step stats name the
    attention configs its runners picked."""
    _, tcfg, _, model = _build(arch)
    prompts = _prompts(tcfg.vocab_size, (12, 20, 7), 2)
    kw = dict(max_seqs=2, num_pages=32, max_model_len=128,
              packed_attention=False, device="cpu")
    runs = []
    for drive in ("generate", "stream"):
        eng = TEngine(tcfg, model, **kw)
        reqs = [Request(prompt=list(p), max_new_tokens=5, seed=i,
                        **(SAMPLED if i == 1 else {}))
                for i, p in enumerate(prompts)]
        if drive == "generate":
            eng.generate(reqs)
            pairs = None
        else:
            pairs = _streamed(eng, reqs)
            for i, r in enumerate(reqs):
                assert [t for j, t in pairs if j == i] == r.output
        _assert_no_leak(eng, reqs)
        runs.append((eng, reqs))
    (ge, gr), (se, sr) = runs
    # a padded step's stats report the configs its runners picked (the
    # last step decodes; xlstm has no attention to configure)
    want = set() if arch == "xlstm-350m" else {"decode"}
    assert set(ge.last_step_stats["dispatch"]) == want
    assert [r.output for r in sr] == [r.output for r in gr]
    assert se.step_idx == ge.step_idx
    assert se.compile_events == ge.compile_events
    assert dict(se.device_calls) == dict(ge.device_calls)
    assert "unified" not in se.device_calls


# ---------------------------------------------------------------------------
# the pinned copies and the device inputs, as host bookkeeping
# ---------------------------------------------------------------------------


def test_token_copies_alternate_and_guard_reuse():
    """Two buffers used in turn, each launch's ids read back exactly; a
    third copy before the oldest is read raises, as does reading a buffer
    twice.  A copy's ids survive the next launch's copy (the async loop
    reads step N after it dispatched N+1)."""
    tc = cuda_graphs.TokenCopies(4, torch.device("cpu"))
    rng = np.random.default_rng(0)
    ids = [torch.from_numpy(rng.integers(0, 1000, 4).astype(np.int32))
           for _ in range(5)]
    a = tc.start(ids[0])
    b = tc.start(ids[1])
    assert (a, b) == (0, 1) and tc.pending == [True, True]
    with pytest.raises(RuntimeError, match="more than two launches"):
        tc.start(ids[2])
    np.testing.assert_array_equal(tc.wait(a), ids[0].numpy())
    with pytest.raises(RuntimeError, match="no copy pending"):
        tc.wait(a)
    c = tc.start(ids[2])  # the freed buffer
    assert c == 0
    want_b = ids[1].numpy().copy()
    ids[1].fill_(-7)  # the source changes after the copy: no aliasing
    np.testing.assert_array_equal(tc.wait(b), want_b)
    np.testing.assert_array_equal(tc.wait(c), ids[2].numpy())
    assert tc.starts == 3 and tc.pending == [False, False]
    out = tc.bufs[0].numpy()
    held = tc.wait(tc.start(ids[3]))
    tc.start(ids[4])
    assert not np.shares_memory(held, out)  # `wait` hands out a copy
    np.testing.assert_array_equal(held, ids[3].numpy())


def test_engine_alternates_token_buffers_across_preemption(smollm):
    """Through a preempting async run the engine's launches use the two
    buffers in turn, never a third, and every launch's ids are read once:
    at the end no copy is pending and the starts equal the launches."""
    eng = _engine(smollm, num_pages=13, max_model_len=128)
    reqs = [Request(prompt=p, max_new_tokens=24)
            for p in _prompts(smollm[1].vocab_size, (40, 33, 47, 20), 7)]
    waits = []
    wait = eng._copies.wait

    def traced(i):
        waits.append(i)
        return wait(i)

    eng._copies.wait = traced
    _streamed(eng, reqs)
    assert eng._copies.starts == eng.device_calls["unified"] == len(waits)
    assert waits == [i % 2 for i in range(len(waits))]
    assert eng._copies.pending == [False, False]
    assert eng.sched.has_work is False
    assert sum(len(r.prompt) for r in reqs) > 140, "nothing was preempted"


def test_eager_entry_passes_device_inputs_through():
    """An eager entry runs its body on the uploaded host arrays and the
    device tensors as given (no copy): the packed step's `prev_tokens`."""
    seen = []

    def body(batch):
        seen.append(batch)
        return (batch["a"] + batch.get("prev_tokens", 0),)

    step = cuda_graphs.EagerStep(body, torch.device("cpu"))
    prev = torch.tensor([1, 2, 3], dtype=torch.int32)
    out, = step({"a": np.array([10, 20, 30], np.int32)},
                {"prev_tokens": prev})
    assert seen[0]["prev_tokens"] is prev
    assert out.tolist() == [11, 22, 33]
    out, = step({"a": np.array([4, 5, 6], np.int32)})  # no device inputs
    assert set(seen[1]) == {"a"} and out.tolist() == [4, 5, 6]


def test_packed_batch_always_carries_token_source(smollm):
    """Every packed launch's host arrays hold `token_source` ([1, T], -1
    where the id is in `inputs`) and its device inputs `prev_tokens`
    ([S], zeros with nothing in flight), so one graph per key serves
    synchronous and async steps."""
    eng = _engine(smollm)
    seen = []
    fn_of = eng._get_fn

    def spy(kind, b, s, kcfg=None):
        fn = fn_of(kind, b, s, kcfg)

        def call(arrays, dev=None):
            seen.append((arrays["token_source"].copy(),
                         {k: v.clone() for k, v in (dev or {}).items()}))
            return fn(arrays, dev)
        return call

    eng._get_fn = spy
    reqs = [Request(prompt=p, max_new_tokens=3)
            for p in _prompts(smollm[1].vocab_size, (9, 4), 1)]
    eng.generate(reqs)
    for r in reqs:
        eng.submit(Request(prompt=list(r.prompt), max_new_tokens=3))
    list(eng.stream())
    assert seen and all(set(d) == {"prev_tokens"} for _, d in seen)
    s = 2 * eng.max_seqs
    assert all(d["prev_tokens"].shape == (s,) and
               d["prev_tokens"].dtype == torch.int32 for _, d in seen)
    sync, streamed = seen[:3], seen[3:]
    assert all((src == -1).all() and not d["prev_tokens"].any()
               for src, d in sync)
    # async decode rows name their row of the flight before
    assert any((src >= 0).any() for src, _ in streamed)
    assert all(((src == -1) | ((src >= 0) & (src < s))).all()
               for src, _ in streamed)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_streams_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--num-requests",
         "5", "--max-new-tokens", "4", "--stream", "--chunked-prefill",
         "--max-prefill-tokens", "32"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 5 requests" in out.stdout
    assert "drive: submit() + run()" in out.stdout
    assert "device calls: {'unified':" in out.stdout
