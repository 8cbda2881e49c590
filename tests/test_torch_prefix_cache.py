"""Prefix caching and resumed prefill chunks in the port, on the CPU,
against the JAX package (reduced smollm-135m, fp32, greedy; weights
carried over by `weights.from_jax_params`):

  * `apply_prefill_cached` (a chunk at absolute positions after a prior
    context in the pages) against the reference's `M.apply_prefill_cached`
    within 1e-4, logits and pages; and prefill(S) followed by a resumed
    chunk of c equals prefill(S + c);
  * `prefill_attention_cached` on its plain route against the reference's
    `backend="pallas"` (the Q-Block kernel in interpret mode), with the
    page table narrowed to the context's pages;
  * `Engine(enable_prefix_caching=True)` against the JAX engine on the
    traces of tests/test_prefix_cache.py and tests/test_chunked_prefill.py,
    on the packed step and on the padded step (whose resumed chunks run
    `apply_prefill_cached`): tokens, `prefilled_tokens`,
    `cached_prefill_tokens`, each step's `cached_tokens` and the cache's
    hit / miss / eviction stats, and `compile_events` key for key
    (`prefill_cached/np*` on the padded step); the allocator's page
    conservation after every step (tests/serving_harness.py);
  * the family refusal, and `launch.serve --prefix-caching
    --shared-prefix` on the CPU.
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
from repro.core.attention import backend as jbackend
from repro.core.attention.heuristics import KernelConfig as JKernelConfig
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.attention import backend as tbackend
from repro_torch.core.attention.heuristics import KernelConfig
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request, State

import serving_harness as H

ROOT = Path(__file__).resolve().parents[1]
BUDGET = 16  # tokens a step in the chunked engines (one page), as upstream
MODES = {"packed": {}, "padded": dict(packed_attention=False)}


def _build(arch="smollm-135m"):
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
    return _build()


# ---------------------------------------------------------------------------
# apply_prefill_cached and prefill_attention_cached
# ---------------------------------------------------------------------------


def _resumed_batch(cfg, prior, chunks, np_b, s, seed):
    """A [B, s] resumed-prefill batch: row i holds chunks[i] tokens at
    absolute positions prior[i].., context prior[i] + chunks[i], through
    its own pages (a [B, np_b] table; pages 1.. in order)."""
    rng = np.random.default_rng(seed)
    b = len(prior)
    tokens = np.zeros((b, s), np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))
    pt = np.zeros((b, np_b), np.int32)
    for i, (p, c) in enumerate(zip(prior, chunks)):
        tokens[i, :c] = rng.integers(1, cfg.vocab_size, size=c)
        pos[i] += p
        pt[i] = 1 + i * np_b + np.arange(np_b)
    return {"inputs": tokens, "positions": pos, "page_table": pt,
            "context_lens": np.asarray(prior, np.int32)
            + np.asarray(chunks, np.int32),
            "query_lens": np.asarray(chunks, np.int32)}


def test_apply_prefill_cached_matches_reference(smollm):
    """Three rows resuming after 16, 37 and 0 tokens of prior context
    (random pages, written before), chunks of 9, 20 and 5 padded to 32,
    the page table narrowed to 4 pages: logits within 1e-4, the pages
    written at the chunk's absolute slots within 1e-5."""
    jcfg, tcfg, params, model = smollm
    batch = _resumed_batch(tcfg, (16, 37, 0), (9, 20, 5), np_b=4, s=32,
                           seed=0)
    num_pages = 1 + 3 * 4
    rng = np.random.default_rng(1)
    shape = (tcfg.num_layers, tcfg.num_kv_heads, 1, num_pages,
             tcfg.page_size, tcfg.resolved_head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    kcfg = dict(variant="gqa", block_q=16)
    want, jnew = JM.apply_prefill_cached(
        jcfg, params,
        {"attn": {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}},
        {k: jnp.asarray(v) for k, v in batch.items()}, backend="pallas",
        kernel_cfg=JKernelConfig(**kcfg))
    tcache = {"attn": {"k_pages": torch.from_numpy(kp.copy()),
                       "v_pages": torch.from_numpy(vp.copy())}}
    got, tnew = TM.apply_prefill_cached(
        model, tcache, {k: torch.from_numpy(v) for k, v in batch.items()},
        kernel_cfg=KernelConfig(**kcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tnew["attn"][name].numpy(),
                                   np.asarray(jnew["attn"][name]), atol=1e-5)


@pytest.mark.parametrize("split", [16, 23])
def test_prefill_then_resumed_chunk_equals_whole_prefill(smollm, split):
    """prefill(S) then a resumed chunk of c tokens gives the logits and
    the pages of prefill(S + c), within 1e-4 (S 16: on a page boundary;
    23: inside a page)."""
    _, tcfg, _, model = smollm
    rng = np.random.default_rng(2)
    total, s_pad = 41, 64
    prompt = rng.integers(1, tcfg.vocab_size, size=total)
    num_pages, np_ = 8, 4

    def fresh():
        return TM.make_cache(tcfg, max_seqs=1, num_pages=num_pages,
                             device="cpu")

    pt = torch.arange(1, np_ + 1, dtype=torch.int32)[None]

    def prefill(cache, ids):
        n = len(ids)
        tokens = torch.zeros((1, s_pad), dtype=torch.long)
        tokens[0, :n] = torch.from_numpy(ids)
        return TM.apply_prefill(model, cache, {
            "inputs": tokens,
            "positions": TM.default_positions(tcfg, 1, s_pad),
            "page_table": pt, "context_lens": torch.tensor([n]),
            "query_lens": torch.tensor([n])})[0]

    whole_cache = fresh()
    want = prefill(whole_cache, prompt)
    cache = fresh()
    prefill(cache, prompt[:split])
    c = total - split
    tokens = torch.zeros((1, 32), dtype=torch.long)
    tokens[0, :c] = torch.from_numpy(prompt[split:])
    got, _ = TM.apply_prefill_cached(model, cache, {
        "inputs": tokens,
        "positions": TM.default_positions(tcfg, 1, 32) + split,
        "page_table": pt, "context_lens": torch.tensor([total]),
        "query_lens": torch.tensor([c])})
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    live = slice(1, 1 + -(-total // tcfg.page_size))
    for name in ("k_pages", "v_pages"):
        torch.testing.assert_close(cache["attn"][name][:, :, :, live],
                                   whole_cache["attn"][name][:, :, :, live],
                                   atol=1e-5, rtol=1e-5)


def test_apply_prefill_cached_refuses_recurrent_families():
    _, tcfg, _, model = _build("xlstm-350m")
    with pytest.raises(ValueError, match="page-addressable"):
        TM.apply_prefill_cached(model, {}, {})


@pytest.mark.parametrize("block_q", [8, 16])
def test_prefill_attention_cached_plain_matches_pallas(block_q):
    """The resumed uniform prefill on its plain route against the
    reference's Pallas kernel in interpret mode: B 3 rows of chunks 13 /
    32 / 1 (padded to 32) after prior contexts 19 / 64 / 0, Hq 4 over Hkv
    2, page 8, the page table narrowed to the 16 pages of the longest
    context; rows past a chunk are zeros on both sides."""
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d, ps, np_b = 3, 32, 4, 2, 16, 8, 16
    prior, chunks = np.array([19, 64, 0]), np.array([13, 32, 1])
    num_pages = 1 + b * np_b
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, 1, num_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, 1, num_pages, ps, d)).astype(np.float32)
    pt = (1 + rng.permutation(b * np_b).reshape(b, np_b)).astype(np.int32)
    ctx = (prior + chunks).astype(np.int32)
    qlens = chunks.astype(np.int32)
    want = jbackend.prefill_attention_cached(
        "pallas", jnp.asarray(q), jnp.asarray(qlens), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(ctx), scale=0.25,
        kernel_cfg=JKernelConfig("gqa", block_q=block_q))
    got = tbackend.prefill_attention_cached(
        torch.from_numpy(q), torch.from_numpy(qlens), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(pt), torch.from_numpy(ctx),
        scale=0.25, kernel_cfg=KernelConfig("gqa", block_q=block_q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for i, n in enumerate(chunks):
        assert not got[i, n:].any()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


def _events(eng):
    return [(kind, b, s, None if k is None else dataclasses.asdict(k))
            for kind, b, s, k in eng.compile_events]


def _drive(eng, reqs, drive):
    """Run `reqs` to the end by `step()` (checking the allocator's page
    conservation after each) or by `stream()`; returns each step's
    `cached_tokens` (step-driven only)."""
    for r in reqs:
        eng.add_request(r)
    if drive == "stream":
        list(eng.stream())
        return None
    stats = []
    while eng.sched.has_work:
        st = eng.step()
        H.assert_step_invariants(eng, st)
        stats.append({k: st[k] for k in ("cached_tokens", "preempted")})
    return stats


def _run_both(built, prompts, *, new, mode="packed", drive="generate",
              jeng=None, teng=None, **kw):
    """The same prompts through the JAX engine and the port's (CPU), with
    `kw` and the mode's flags: the tokens, the prefill accounting, each
    step's cached tokens and preemptions, the prefix cache's stats and the
    compile events must agree.  Pass `jeng` / `teng` to reuse engines
    (multi-turn).  Returns (port engine, port requests, port step
    stats)."""
    jcfg, tcfg, params, model = built
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256) | MODES[mode] \
        | kw
    jeng = jeng or JEngine(jcfg, params, **eng_kw)
    teng = teng or TEngine(tcfg, model, device="cpu", **eng_kw)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    treqs = [Request(prompt=list(p), max_new_tokens=new) for p in prompts]
    jstats = _drive(jeng, jreqs, drive)
    tstats = _drive(teng, treqs, drive)
    assert all(r.state is State.FINISHED for r in treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.num_cached_tokens for r in treqs] == \
        [r.num_cached_tokens for r in jreqs]
    assert tstats == jstats
    assert teng.prefilled_tokens == jeng.prefilled_tokens
    assert teng.cached_prefill_tokens == jeng.cached_prefill_tokens
    assert teng.step_idx == jeng.step_idx
    assert _events(teng) == _events(jeng)
    assert dict(teng.device_calls) == dict(jeng.device_calls)
    if teng.prefix_cache is not None:
        assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    return jeng, teng, treqs, tstats


def _port_only(built, prompts, *, new, mode="packed", **kw):
    """A baseline run of the port alone (its uncached, unchunked steps are
    held to the JAX engine by tests/test_torch_engine.py and
    tests/test_torch_cuda_graphs.py): (engine, requests, step stats)."""
    _, tcfg, _, model = built
    eng = TEngine(tcfg, model, device="cpu",
                  **(dict(max_seqs=4, num_pages=64, max_model_len=256)
                     | MODES[mode] | kw))
    reqs = [Request(prompt=list(p), max_new_tokens=new) for p in prompts]
    stats = _drive(eng, reqs, "generate")
    assert all(r.state is State.FINISHED for r in reqs)
    return eng, reqs, stats


@pytest.mark.parametrize("mode,drive", [("packed", "generate"),
                                        ("packed", "stream"),
                                        ("padded", "generate"),
                                        ("padded", "stream")])
def test_shared_prefix_matches_reference(smollm, mode, drive):
    """tests/test_prefix_cache.py:267: two slots, four prompts sharing a
    40-token prefix; the second admission wave hits two full pages each.
    Equal to the JAX engine, and to the port's own cache-off run while
    prefilling 2 x 32 tokens fewer."""
    cfg = smollm[0]
    prompts = H.shared_prefix_prompts(cfg, np.random.default_rng(7), 40,
                                      (7, 12, 9, 5))
    _, teng, treqs, _ = _run_both(smollm, prompts, new=6, mode=mode,
                                  drive=drive, max_seqs=2,
                                  enable_prefix_caching=True)
    assert teng.prefix_cache.hits >= 2
    assert teng.cached_prefill_tokens == 2 * (40 // cfg.page_size) \
        * cfg.page_size
    off, reqs, _ = _port_only(smollm, prompts, new=6, mode=mode, max_seqs=2)
    assert [r.output for r in treqs] == [r.output for r in reqs]
    assert teng.prefilled_tokens == \
        off.prefilled_tokens - teng.cached_prefill_tokens
    if mode == "padded":
        assert teng.device_calls["prefill_cached"] > 0
        assert any(k[0].startswith("prefill_cached/np")
                   for k in teng.compile_events)


@pytest.mark.parametrize("mode", MODES)
def test_eviction_under_pressure_matches_reference(smollm, mode):
    """tests/test_prefix_cache.py:313: a 12-page pool reclaims cached
    pages LRU-first; outputs equal the JAX engine's and the roomy
    cache-off run's."""
    cfg = smollm[0]
    prompts = H.shared_prefix_prompts(cfg, np.random.default_rng(9), 32,
                                      (6, 4, 8, 5, 7))
    _, _, treqs, _ = _run_both(smollm, prompts, new=8, mode=mode,
                               max_seqs=2, num_pages=12, max_model_len=128,
                               enable_prefix_caching=True)
    _, off, _ = _port_only(smollm, prompts, new=8, mode=mode, max_seqs=2,
                           max_model_len=128)
    assert [r.output for r in treqs] == [r.output for r in off]


@pytest.mark.parametrize("mode", MODES)
def test_preemption_with_caching_matches_reference(smollm, mode):
    """tests/test_prefix_cache.py:330: a 7-page pool preempts; preempted
    requests donate their pages and resume through the cache.  Equal to
    the JAX engine and to the ample-pool run."""
    cfg = smollm[0]
    prompts = H.shared_prefix_prompts(cfg, np.random.default_rng(10), 16,
                                      (8, 8))
    _, ample, _ = _port_only(smollm, prompts, new=8, mode=mode, max_seqs=2,
                             max_model_len=64, enable_prefix_caching=True)
    _, _, starved, _ = _run_both(smollm, prompts, new=8, mode=mode,
                                 max_seqs=2, num_pages=7, max_model_len=64,
                                 enable_prefix_caching=True)
    assert [r.output for r in starved] == [r.output for r in ample]


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_prefix_caching_refuses_recurrent_families(arch):
    """tests/test_prefix_cache.py:347: a family whose state is not
    page-addressable is refused, as the reference refuses it."""
    _, tcfg, _, model = _build(arch)
    with pytest.raises(AssertionError, match="page-addressable"):
        TEngine(tcfg, model, device="cpu", max_seqs=2, num_pages=16,
                max_model_len=64, enable_prefix_caching=True)


@pytest.mark.parametrize("mode", MODES)
def test_multi_turn_reuse_matches_reference(smollm, mode):
    """tests/test_prefix_cache.py:354: turn 2 extends turn 1's whole
    conversation and reuses every full page turn 1 wrote (decode-written
    pages too), on both engines alike."""
    cfg = smollm[0]
    rng = np.random.default_rng(11)
    turn1 = list(rng.integers(1, cfg.vocab_size, size=30))
    jeng, teng, run1, _ = _run_both(smollm, [turn1], new=8, mode=mode,
                                 max_seqs=2, enable_prefix_caching=True)
    assert teng.prefix_cache.hits == 0
    convo = turn1 + run1[0].output
    turn2 = convo + list(rng.integers(1, cfg.vocab_size, size=10))
    _, _, run2, _ = _run_both(smollm, [turn2], new=8, mode=mode, jeng=jeng,
                           teng=teng)
    assert teng.prefix_cache.hits == 1
    reusable = ((len(convo) - 1) // cfg.page_size) * cfg.page_size
    assert run2[0].num_cached_tokens == reusable


@pytest.mark.parametrize("mode", MODES)
def test_chunked_and_cached_configurations_match_reference(smollm, mode):
    """tests/test_chunked_prefill.py:79: {chunked, unchunked} x {cached,
    uncached} on a shared-prefix workload give the same tokens, the cached
    engines equal to the JAX engine; the cached and chunked engine
    computes the fewest prompt tokens."""
    cfg = smollm[0]
    prompts = H.shared_prefix_prompts(cfg, np.random.default_rng(2),
                                      3 * BUDGET, (7, 12, 9, 5))
    runs = {}
    for chunked in (False, True):
        for cached in (False, True):
            run = _run_both if cached else _port_only
            runs[chunked, cached] = run(
                smollm, prompts, new=6, mode=mode, max_seqs=2,
                enable_chunked_prefill=chunked,
                enable_prefix_caching=cached,
                max_prefill_tokens=BUDGET if chunked else 8192)[-3:-1]
    base = [r.output for r in runs[False, False][1]]
    for teng, treqs in runs.values():
        assert [r.output for r in treqs] == base
    total = sum(len(p) for p in prompts)
    assert runs[False, False][0].prefilled_tokens == total
    assert runs[True, True][0].prefilled_tokens \
        < runs[True, False][0].prefilled_tokens == total
    assert runs[True, True][0].cached_prefill_tokens > 0


@pytest.mark.parametrize("mode", MODES)
def test_preempt_resume_chunked_matches_reference(smollm, mode):
    """tests/test_chunked_prefill.py:126: an 8-page pool preempts chunked
    prefills mid-prompt; donated pages and chunk resumes still give the
    ample pool's tokens, on both engines alike."""
    cfg = smollm[0]
    prompts = H.make_prompts(cfg, np.random.default_rng(4),
                             (3 * BUDGET + 10, 3 * BUDGET + 2))
    kw = dict(max_seqs=2, max_model_len=128, enable_chunked_prefill=True,
              enable_prefix_caching=True, max_prefill_tokens=BUDGET)
    _, ample, _ = _port_only(smollm, prompts, new=8, mode=mode, **kw)
    _, _, starved, stats = _run_both(smollm, prompts, new=8, mode=mode,
                                     num_pages=8, **kw)
    assert [r.output for r in starved] == [r.output for r in ample]
    assert sum(st["preempted"] for st in stats) > 0, "the pool never starved"


@pytest.mark.parametrize("mode", MODES)
def test_cache_hit_lands_mid_chunk_matches_reference(smollm, mode):
    """tests/test_chunked_prefill.py:147: a cache hit starts the first
    chunk mid-prompt, off the chunk grid, and the rest still chunks;
    equal to the JAX engine and to the plain engine."""
    cfg = smollm[0]
    rng = np.random.default_rng(5)
    ps = cfg.page_size
    stem = H.make_prompts(cfg, rng, (2 * ps + 9,))[0]
    long_prompt = stem + H.make_prompts(cfg, rng, (3 * BUDGET + 3,))[0]
    _, _, treqs, _ = _run_both(smollm, [stem, long_prompt], new=6, mode=mode,
                               max_seqs=1, enable_chunked_prefill=True,
                               enable_prefix_caching=True,
                               max_prefill_tokens=BUDGET)
    _, plain, _ = _port_only(smollm, [stem, long_prompt], new=6, mode=mode)
    assert [r.output for r in treqs] == [r.output for r in plain]
    assert treqs[1].num_cached_tokens == 2 * ps
    assert 0 < treqs[1].num_cached_tokens < treqs[1].num_prompt_tokens


def test_serve_launcher_prefix_caching_on_cpu():
    """`--prefix-caching --shared-prefix`: the second admission wave hits
    the shared prefix's full pages."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--num-requests",
         "6", "--max-new-tokens", "4", "--max-seqs", "2", "--rate", "6",
         "--prefix-caching", "--shared-prefix", "40"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 6 requests" in out.stdout
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("drive:"))
    cached = int(line.split("cached_prefill_tokens")[1])
    assert cached >= 4 * 32, line
    assert "prefix cache: {'cache_hits':" in out.stdout
