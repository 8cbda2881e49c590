"""Speculative decoding and the two-dispatch sampler in the port, on the
CPU, against the JAX package (reduced smollm-135m, fp32; weights carried
over by `weights.from_jax_params`):

  * the drafter copy (`repro_torch.serving.draft`) against
    `repro.serving.draft` on seeded random and cyclic histories: the same
    proposals at every point of an incremental build, the same adaptive-k
    trajectory;
  * the verify epilogue: `apply_unified(max_draft=4)` against the
    reference's `M.apply_unified(..., sample=True, max_draft=4)`, greedy,
    on one packed batch of plain decode rows, a dead row, a fresh chunk
    and verify rows that accept two of four drafts and both of two:
    tokens and accept counts equal, last-token logits within 1e-4; the
    verify step's noise rows at sequential counters;
  * `Engine(speculative=True)` against the JAX spec engine, greedy, on
    the reference's three traces (tests/test_spec_decode.py: the mixed
    trace; chunked prefill with prefix caching; 24 pages for 4 slots):
    outputs, `spec_stats`, steps, launched token slots, dispatch counts,
    `compile_events` and device calls equal, the allocator's page
    conservation after every step, no page leaked;
  * sampled requests (temperature 0.8, top-k 20, seed 7): the spec
    engine's tokens are the port's non-speculative tokens (the RNG bits
    differ from JAX's by design, so this is held against the port);
    `stream()` under speculation equals `generate()`;
  * `fused_sampling=False` equals the fused port (greedy and sampled)
    with {"unified": n, "sample": n} device calls, and the JAX
    `fused_sampling=False` engine on greedy outputs;
  * `launch.serve --speculative` and `--no-fused-sampling` on the CPU.

The JAX engines run only for the runs under test (their compiles
dominate); the non-speculative baselines are the port's alone, held to
the JAX engine by tests/test_torch_engine.py.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.attention.heuristics import KernelConfig as JKernelConfig
from repro.models import model as JM
from repro.serving import draft as jdraft
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.attention.heuristics import KernelConfig
from repro_torch.models import model as TM
from repro_torch.models import sampling as TS
from repro_torch.serving import draft as tdraft
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request, State

import serving_harness as H

ROOT = Path(__file__).resolve().parents[1]
CYCLE = [5, 9, 17, 3]
ENGINE = dict(max_seqs=4, num_pages=64, max_model_len=256)
SAMPLED = dict(temperature=0.8, top_k=20, seed=7)
SPEC = dict(speculative=True, draft_k=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model is tiny: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smollm():
    jcfg = jreduced(JARCHS["smollm-135m"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["smollm-135m"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _traces(vocab):
    """tests/test_spec_decode.py's traces: (prompts, new tokens, engine
    flags).  "mixed": two repetitive prompts (n-gram hits) and a random
    one; "chunked_cached": chunked prefill at 16 with prefix caching;
    "pressure": 24 pages for 4 slots, so drafts grow and roll back page
    runs all the time."""
    rng = np.random.default_rng(0)
    mixed = [CYCLE * 6, (CYCLE * 5)[:18],
             list(map(int, rng.integers(1, vocab, size=9)))]
    rng = np.random.default_rng(3)
    four = [CYCLE * 8, (CYCLE * 6)[:22],
            list(map(int, rng.integers(1, vocab, size=9))), CYCLE * 3]
    return {
        "mixed": (mixed, 16, {}),
        "chunked_cached": (four, 14, dict(enable_chunked_prefill=True,
                                          max_prefill_tokens=16,
                                          enable_prefix_caching=True)),
        "pressure": (four, 14, dict(num_pages=24, max_seqs=4)),
    }


TRACES = ("mixed", "chunked_cached", "pressure")


# ---------------------------------------------------------------------------
# the drafter copy
# ---------------------------------------------------------------------------


def _history(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":  # a small alphabet: n-grams do recur
        return list(map(int, rng.integers(0, 6, size=120)))
    cycle = list(map(int, rng.integers(0, 50, size=int(rng.integers(2, 7)))))
    noise = list(map(int, rng.integers(50, 60, size=5)))
    return cycle * 8 + noise + cycle * 6 + [cycle[0]] * 4


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1),
                                       ("random", 2), ("cyclic", 0),
                                       ("cyclic", 1), ("cyclic", 2)])
def test_drafter_matches_reference(kind, seed):
    """Both tables built in the same seeded chunks propose the same drafts
    at every point for k 1..6 (n-grams 1-3, and 2-2); both controllers
    fed the same seeded (proposed, accepted) outcomes follow the same k
    and EMA; both `Drafter`s give a growing request the same drafts."""
    toks = _history(kind, seed)
    rng = np.random.default_rng(100 + seed)
    for lo, hi in ((1, 3), (2, 2)):
        want, got = jdraft.NGramTable(lo, hi), tdraft.NGramTable(lo, hi)
        i = 0
        while i < len(toks):
            n = int(rng.integers(1, 5))
            want.extend(toks[i:i + n])
            got.extend(toks[i:i + n])
            i += n
            for k in range(1, 7):
                assert got.propose(k) == want.propose(k), (i, k)
    for cfg in ({}, dict(adaptive=False), dict(max_draft=6, low=0.2,
                                                 high=0.8, ema_alpha=0.5)):
        want = jdraft.DraftController(jdraft.SpecConfig(**cfg))
        got = tdraft.DraftController(tdraft.SpecConfig(**cfg))
        for _ in range(60):
            p = int(rng.integers(0, 5))
            a = int(rng.integers(0, p + 1))
            want.observe(p, a)
            got.observe(p, a)
            assert (got.k, got.ema, got.accept_rate) == \
                (want.k, want.ema, want.accept_rate)
    jd, td = jdraft.Drafter(), tdraft.Drafter()
    req = Request(prompt=toks[:40], max_new_tokens=200)
    for t in toks[40:]:
        assert td.propose(req) == jd.propose(req)
        req.output.append(t)
    td.forget(req.req_id)
    assert not td._tables


# ---------------------------------------------------------------------------
# the verify epilogue
# ---------------------------------------------------------------------------


def _verify_batch(cfg, num_pages, np_, drafts):
    """A packed verify step, ms = 3: decode rows at contexts (20, dead,
    35); chunk rows: a fresh chunk of 12, a verify row of [last] + drafts
    [4] after 30 tokens, one of [last] + drafts [2] after 25, and an
    empty slot.  Greedy sampling rows everywhere."""
    rng = np.random.default_rng(0)
    ps, ms = cfg.page_size, 3
    s = 2 * ms
    chunks = [(0, 12, None), (30, 5, 4), (25, 3, 2)]  # (start, n, spec)
    n_pref = sum(n for _, n, _ in chunks)
    t = ms + max(1 << (n_pref - 1).bit_length(), ps)
    pt = (1 + np.arange(s * np_).reshape(s, np_)).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab_size, size=(1, t)).astype(np.int32)
    pos = np.zeros((1, t), np.int32)
    slots = np.full((1, t), num_pages * ps, np.int32)
    qlens = np.zeros((s,), np.int32)
    ctx = np.zeros((s,), np.int32)
    spec = np.zeros((s,), np.int32)
    qsl = np.full((s + 1,), ms, np.int32)
    qsl[:ms + 1] = np.arange(ms + 1)
    qlens[:ms] = 1
    for i, c in enumerate((20, 0, 35)):
        if c:
            pos[0, i], ctx[i] = c - 1, c
            slots[0, i] = pt[i, (c - 1) // ps] * ps + (c - 1) % ps
        else:
            tokens[0, i] = 0
    cur = ms
    for j, (start, n, k) in enumerate(chunks):
        i = ms + j
        p = np.arange(start, start + n)
        if k:
            spec[i] = k
            tokens[0, cur + 1: cur + n] = drafts[i]
        pos[0, cur:cur + n] = p
        slots[0, cur:cur + n] = pt[i, p // ps] * ps + p % ps
        ctx[i], qlens[i] = start + n, n
        cur += n
        qsl[i + 1:] = cur
    return {"inputs": tokens, "positions": pos, "page_table": pt,
            "context_lens": ctx, "query_lens": qlens,
            "query_start_loc": qsl, "slot_mapping": slots,
            "temperature": np.zeros((s,), np.float32),
            "top_p": np.ones((s,), np.float32),
            "top_k": np.zeros((s,), np.int32),
            "stream_ids": np.arange(s, dtype=np.int32),
            "num_generated": np.zeros((s,), np.int32), "spec_lens": spec}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_verify_epilogue_matches_reference(smollm, backend):
    """Drafts chosen on the port so that the 4-draft row accepts its
    first two (then two wrong ones) and the 2-draft row accepts both;
    then the same batch through the reference (`backend="pallas"`: the
    Pallas kernels in interpret mode): tokens [S, 5] and accept counts
    equal, last-token logits within 1e-4."""
    jcfg, tcfg, params, model = smollm
    num_pages, np_ = 40, 6
    shape = (tcfg.num_layers, tcfg.num_kv_heads, 1, num_pages,
             tcfg.page_size, tcfg.resolved_head_dim)
    rng = np.random.default_rng(1)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    kcfg = dict(variant="gqa", block_q=16)

    def port(batch):
        cache = {"k_pages": torch.from_numpy(kp.copy()),
                 "v_pages": torch.from_numpy(vp.copy())}
        toks, emitted, logits, _ = TM.apply_unified(
            model, cache, {k: torch.from_numpy(v) for k, v in batch.items()},
            kernel_cfg=KernelConfig(**kcfg), num_decode_seqs=3, sample=True,
            return_logits=True, max_draft=4)
        return toks.numpy(), emitted.numpy(), logits.numpy()

    drafts = {4: [1, 2, 3, 4], 5: [1, 2]}
    for j in range(2):  # draft j + 1 := the target sampled at position j
        toks, _, _ = port(_verify_batch(tcfg, num_pages, np_, drafts))
        for i in drafts:
            drafts[i][j] = int(toks[i, j])
    toks, _, _ = port(_verify_batch(tcfg, num_pages, np_, drafts))
    drafts[4][2] = (int(toks[4, 2]) + 1) % tcfg.vocab_size
    batch = _verify_batch(tcfg, num_pages, np_, drafts)
    toks, emitted, logits = port(batch)
    assert list(emitted) == [1, 1, 1, 1, 3, 3]
    jcache = {"attn": {"k_pages": jnp.asarray(kp),
                       "v_pages": jnp.asarray(vp)}}
    jtoks, jemitted, jlogits, _ = JM.apply_unified(
        jcfg, params, jcache, {k: jnp.asarray(v) for k, v in batch.items()},
        backend=backend, kernel_cfg=JKernelConfig(**kcfg),
        num_decode_seqs=3, sample=True, return_logits=True, max_draft=4)
    np.testing.assert_array_equal(emitted, np.asarray(jemitted))
    live = np.arange(5)[None, :] < emitted[:, None]  # consumed columns
    np.testing.assert_array_equal(np.where(live, toks, -1),
                                  np.where(live, np.asarray(jtoks), -1))
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)


def test_verify_noise_rows_draw_sequential_counters():
    """`sampling.verify_rows`: verify position j of row i is noise row
    i * (k + 1) + j, drawn at counter num_generated[i] + j, only for hot
    rows and j <= spec_lens[i]; each such row is bit for bit the draw a
    plain step at that counter makes."""
    temps = np.array([0.0, 0.8, 0.5], np.float32)
    streams, ngen = np.array([3, 4, 5]), np.array([10, 20, 30])
    rs, rn, rows = TS.verify_rows(temps, streams, ngen, [2, 1, 0], 2)
    assert rows == [3, 4, 6]
    assert list(rs) == [3, 3, 3, 4, 4, 4, 5, 5, 5]
    assert list(rn) == [10, 11, 12, 20, 21, 22, 30, 31, 32]
    got = TS.gumbel_noise(7, rs, rn, 64, "cpu", rows=rows)
    for r in range(9):
        i, j = divmod(r, 3)
        if r in rows:
            want = TS.gumbel_noise(7, [streams[i]], [ngen[i] + j], 64, "cpu")
            assert torch.equal(got[r], want[0])
        else:
            assert not got[r].any()


def test_verify_needs_sampling(smollm):
    with pytest.raises(ValueError, match="sample=True"):
        TM.apply_unified(smollm[3], {}, {}, max_draft=4)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


def _events(eng):
    return [(kind, b, s, None if k is None else dataclasses.asdict(k))
            for kind, b, s, k in eng.compile_events]


def _port(tcfg, model, prompts, new, req_kw=None, drive="generate", **kw):
    """The prompts through the port's engine (CPU): step-driven with the
    allocator's page conservation checked after every step, or through
    `stream()`.  Returns (engine, requests)."""
    eng = TEngine(tcfg, model, device="cpu", **(ENGINE | kw))
    reqs = [Request(prompt=list(p), max_new_tokens=new, **(req_kw or {}))
            for p in prompts]
    for r in reqs:
        eng.add_request(r)
    if drive == "stream":
        list(eng.stream())
    else:
        while eng.sched.has_work:
            H.assert_step_invariants(eng, eng.step())
    assert all(r.state is State.FINISHED for r in reqs)
    assert eng.alloc.free_pages == eng.num_pages - 1, "pages leaked"
    return eng, reqs


def _jax(jcfg, params, prompts, new, **kw):
    eng = JEngine(jcfg, params, **(ENGINE | kw))
    reqs = [JRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    eng.generate(reqs)
    return eng, reqs


def _same_engines(teng, treqs, jeng, jreqs):
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.step_idx == jeng.step_idx
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    assert _events(teng) == _events(jeng)
    assert dict(teng.device_calls) == dict(jeng.device_calls)
    assert teng.prefilled_tokens == jeng.prefilled_tokens


@pytest.mark.parametrize("trace", TRACES)
def test_spec_engine_matches_reference(smollm, trace):
    """Greedy, draft_k 4: the port's spec engine against the JAX spec
    engine, and its tokens against the port's non-speculative run."""
    jcfg, tcfg, params, model = smollm
    prompts, new, kw = _traces(tcfg.vocab_size)[trace]
    teng, treqs = _port(tcfg, model, prompts, new, **SPEC, **kw)
    jeng, jreqs = _jax(jcfg, params, prompts, new, **SPEC, **kw)
    _same_engines(teng, treqs, jeng, jreqs)
    assert teng.spec_stats == jeng.spec_stats
    assert teng.spec_stats["accepted"] > 0
    assert teng.drafter.controller.k == jeng.drafter.controller.k
    if teng.prefix_cache is not None:
        assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()
    _, base = _port(tcfg, model, prompts, new, **kw)
    assert [r.output for r in treqs] == [r.output for r in base]


@pytest.mark.parametrize("trace", TRACES)
def test_spec_sampled_matches_plain_port(smollm, trace):
    """Temperature 0.8, top-k 20, seed 7: each verify position draws at
    the counter sequential decoding uses, so the spec engine's tokens are
    the port's own non-speculative tokens; still one device call a
    step."""
    _, tcfg, _, model = smollm
    prompts, new, kw = _traces(tcfg.vocab_size)[trace]
    spec, sreqs = _port(tcfg, model, prompts, new, SAMPLED, **SPEC, **kw)
    _, base = _port(tcfg, model, prompts, new, SAMPLED, **kw)
    assert [r.output for r in sreqs] == [r.output for r in base]
    assert spec.spec_stats["proposed"] > 0
    assert dict(spec.device_calls) == {"unified": spec.step_idx}


def test_spec_one_device_call_per_step(smollm):
    """tests/test_spec_decode.py:127: verify, accept and the bonus sample
    ride in the packed launch: {"unified": steps}, and a repetitive trace
    accepts more than one draft a step and saves steps."""
    _, tcfg, _, model = smollm
    prompts = [CYCLE * 6, (CYCLE * 5)[:18]]
    eng, _ = _port(tcfg, model, prompts, 16, **SPEC)
    base, _ = _port(tcfg, model, prompts, 16)
    assert eng.spec_stats["steps"] > 0
    assert dict(eng.device_calls) == {"unified": eng.step_idx}
    st = eng.spec_stats
    assert st["accepted"] / eng.step_idx > 1.0, st
    assert st["accepted"] < st["emitted"] <= st["accepted"] + \
        st["steps"] * eng.max_seqs
    assert eng.step_idx < base.step_idx


@pytest.mark.parametrize("trace", TRACES)
def test_spec_stream_matches_generate(smollm, trace):
    """`stream()` steps a spec engine synchronously: the same tokens,
    steps and spec stats as `generate()`, greedy and sampled."""
    _, tcfg, _, model = smollm
    prompts, new, kw = _traces(tcfg.vocab_size)[trace]
    for req_kw in (None, SAMPLED):
        a, areqs = _port(tcfg, model, prompts, new, req_kw, "stream", **SPEC,
                         **kw)
        b, breqs = _port(tcfg, model, prompts, new, req_kw, **SPEC, **kw)
        assert [r.output for r in areqs] == [r.output for r in breqs]
        assert a.step_idx == b.step_idx
        assert a.spec_stats == b.spec_stats


@pytest.mark.parametrize("req_kw", [None, SAMPLED],
                         ids=["greedy", "sampled"])
def test_two_dispatch_matches_fused(smollm, req_kw):
    """`fused_sampling=False`: the packed launch returns its logits and a
    second dispatch samples them: the fused port's tokens, with
    {"unified": n, "sample": n}; `stream()` the same."""
    _, tcfg, _, model = smollm
    prompts, new, kw = _traces(tcfg.vocab_size)["chunked_cached"]
    fused, freqs = _port(tcfg, model, prompts, new, req_kw, **kw)
    two, treqs = _port(tcfg, model, prompts, new, req_kw,
                       fused_sampling=False, **kw)
    streamed, sreqs = _port(tcfg, model, prompts, new, req_kw, "stream",
                            fused_sampling=False, **kw)
    n = two.step_idx
    assert [r.output for r in treqs] == [r.output for r in freqs] == \
        [r.output for r in sreqs]
    assert dict(two.device_calls) == {"unified": n, "sample": n}
    assert dict(streamed.device_calls) == dict(two.device_calls)


def test_two_dispatch_matches_reference(smollm):
    """The port's `fused_sampling=False` engine against the JAX one on
    the mixed trace, greedy; and the gating: a spec engine needs the
    fused step, fused sampling needs the packed step, `spec_config` sets
    the draft width."""
    jcfg, tcfg, params, model = smollm
    prompts, new, kw = _traces(tcfg.vocab_size)["mixed"]
    teng, treqs = _port(tcfg, model, prompts, new, fused_sampling=False)
    jeng, jreqs = _jax(jcfg, params, prompts, new, fused_sampling=False)
    _same_engines(teng, treqs, jeng, jreqs)
    gated = TEngine(tcfg, model, device="cpu", fused_sampling=False,
                    **SPEC, **ENGINE)
    assert gated.drafter is None and gated.max_draft == 0
    padded = TEngine(tcfg, model, device="cpu", packed_attention=False,
                     **SPEC, **ENGINE)
    assert (padded._fused, padded._spec) == (False, False)
    # a spec_config sets the drafter and the verify width: K + 1 noise
    # rows and K + 2 id columns a sequence
    spec = TEngine(tcfg, model, device="cpu", speculative=True,
                   spec_config=tdraft.SpecConfig(max_draft=2), **ENGINE)
    assert spec.max_draft == spec.drafter.cfg.max_draft == 2
    assert spec._noise.shape == (2 * 4 * 3, tcfg.vocab_size)
    assert spec._copies.bufs[0].shape == (2 * 4, 4)


@pytest.mark.parametrize("flags,want", [
    (["--speculative", "--draft-k", "3"], "speculative decoding:"),
    (["--no-fused-sampling"], "'sample': ")])
def test_serve_launcher_spec_and_two_dispatch_on_cpu(flags, want):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--num-requests",
         "4", "--max-new-tokens", "8", "--max-seqs", "2", *flags],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    assert want in out.stdout, out.stdout
