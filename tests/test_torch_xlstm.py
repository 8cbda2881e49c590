"""The port's ssm family (xlstm) on the padded per-kind step against the
JAX reference on the CPU, on `reduced(ARCHS["xlstm-350m"])` in fp32 (4
layers: two groups of one mLSTM and one sLSTM block, d_model 256, 2 heads
x 256, chunk 32) with the weights of `M.init(cfg, key(0))`:

  * the layout and the cache tree (keys, shapes, dtypes, both stabilisers
    at -inf, no "attn" entry);
  * `apply_prefill` (ragged rows) then two `apply_decode` steps (the
    second with a dead slot) against `M.apply_prefill` / `M.apply_decode`:
    logits and every cache leaf at atol / rtol 1e-4;
  * prefill(S+1) == prefill(S) + decode, as tests/test_models_smoke.py
    checks the reference (2e-4);
  * the port's `Engine` token for token against the JAX `Engine` on the
    prompts of tests/test_serving_engine.py::test_engine_ssm_archs, with
    identical device calls and launched token rows, and no attention
    dispatch;
  * the engine refuses chunked prefill for xlstm, as the reference does;
  * `launch.serve --arch xlstm-350m --reduced --device cpu`.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request as TRequest, State

TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def xlstm():
    jcfg = jreduced(JARCHS["xlstm-350m"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["xlstm-350m"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _tree(cache):
    return {g: {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for n, t in leaves.items()} for g, leaves in cache.items()}


def _assert_cache_equal(tcache, jcache):
    assert set(tcache) == set(jcache)
    for group, leaves in jcache.items():
        for name, want in leaves.items():
            got = tcache[group][name]
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"{group}.{name}", **TOL)


def test_layout_and_cache_match_reference(xlstm):
    jcfg, tcfg, _, model = xlstm
    assert TM.xlstm_layout(tcfg) == JM.xlstm_layout(jcfg) == (2, 2, 1)
    assert TM.attn_layer_count(tcfg) == JM.attn_layer_count(jcfg) == 0
    assert len(model.mlstm) == len(model.mlstm_ln) == 2
    assert len(model.slstm) == len(model.slstm_ln) == 2
    jc = JM.make_cache(jcfg, max_seqs=3, num_pages=5)
    tc = TM.make_cache(tcfg, max_seqs=3, num_pages=5, device="cpu")
    assert "attn" not in tc
    assert _tree(tc) == _tree(jc)
    for group in ("mlstm", "slstm"):
        for name, t in tc[group].items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(jc[group][name]))
        assert torch.isneginf(tc[group]["m"]).all()


def test_weights_round_trip(xlstm):
    _, tcfg, params, model = xlstm
    got = weights.to_numpy_params(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    rand = weights.init_random(tcfg.replace(dtype="bfloat16"), 0,
                               device="cpu")
    assert rand.mlstm[0].w_gates.w.dtype == torch.float32
    assert rand.mlstm[0].wq.w.dtype == torch.bfloat16
    r = rand.slstm[0].r.float()
    dh = tcfg.d_model // tcfg.ssm.num_heads
    assert abs(float(r.std()) - 0.88 * dh ** -0.5) < 0.1 * dh ** -0.5
    assert not rand.slstm[0].w_in.b.any()


def test_prefill_then_decode_match_reference(xlstm):
    jcfg, tcfg, params, model = xlstm
    b, s = 2, 32
    pt = np.zeros((b, 4), np.int32)  # no pages: xlstm holds none
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, size=(b, s + 2)).astype(np.int32)
    qlens = np.asarray([s, 21], np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jcache = JM.make_cache(jcfg, max_seqs=b, num_pages=4)
    tcache = TM.make_cache(tcfg, max_seqs=b, num_pages=4, device="cpu")
    jb, tb = _both({"inputs": tokens[:, :s], "positions": pos,
                    "page_table": pt, "context_lens": qlens,
                    "query_lens": qlens})
    jl, jcache = JM.apply_prefill(jcfg, params, jcache, jb)
    tl, tcache = TM.apply_prefill(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(tcache, jcache)
    ctx = qlens.copy()
    for live in ([True, True], [True, False]):
        live = np.asarray(live)
        inp = np.where(live, tokens[np.arange(b), ctx], 0)[:, None]
        p = np.where(live, ctx, -1)[:, None].astype(np.int32)
        c = np.where(live, ctx + 1, 0).astype(np.int32)
        jb, tb = _both({"inputs": inp, "positions": p, "page_table": pt,
                        "context_lens": c})
        jl, jcache = JM.apply_decode(jcfg, params, jcache, jb)
        tl, tcache = TM.apply_decode(model, tcache, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_equal(tcache, jcache)
        ctx = np.where(live, ctx + 1, ctx)


def test_prefill_decode_consistency(xlstm):
    """prefill(S+1) == prefill(S) + decode(1) inside the port."""
    _, tcfg, _, model = xlstm
    b, s = 2, 24
    pt = torch.zeros((b, 2), dtype=torch.int32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(b, s + 1)))
    pos = TM.default_positions(b, s + 1)

    def prefill(n):
        cache = TM.make_cache(tcfg, max_seqs=b, num_pages=2, device="cpu")
        q = torch.full((b,), n, dtype=torch.int32)
        return TM.apply_prefill(model, cache, {
            "inputs": toks[:, :n], "positions": pos[:, :n], "page_table": pt,
            "context_lens": q, "query_lens": q})

    l1, _ = prefill(s + 1)
    _, cache = prefill(s)
    l2, _ = TM.apply_decode(model, cache, {
        "inputs": toks[:, s:], "positions": pos[:, s:], "page_table": pt,
        "context_lens": torch.full((b,), s + 1, dtype=torch.int32)})
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=2e-4, rtol=2e-4)


def test_engine_matches_reference(xlstm):
    jcfg, tcfg, params, model = xlstm
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size, size=n)))
               for n in (12, 20, 7)]
    kw = dict(max_seqs=2, num_pages=32, max_model_len=128)
    jeng = JEngine(jcfg, params, **kw)
    teng = TEngine(tcfg, model, device="cpu", **kw)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=4) for p in prompts]
    treqs = [TRequest(prompt=list(p), max_new_tokens=4) for p in prompts]
    jeng.generate(jreqs)
    teng.generate(treqs)
    assert all(r.state is State.FINISHED for r in treqs)
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert a.output == b.output, (i, a.output, b.output)
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts) == {}
    assert dict(teng.device_calls) == dict(jeng.device_calls)
    assert not teng._packed and "attn" not in teng.cache
    assert teng.device_calls["prefill"] > 0


def test_engine_matches_reference_under_preemption(xlstm):
    """13 pages of 16 (12 usable: xlstm holds no KV, but the scheduler
    still pages every request) for four requests that need ~18: decoding
    requests are preempted (their output folds into the prompt) and
    prefilled again from the empty state.  Tokens, steps, launched token
    rows and device calls equal the reference's, and no page leaks."""
    jcfg, tcfg, params, model = xlstm
    lens = (40, 33, 47, 20)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size, size=n)))
               for n in lens]
    kw = dict(max_seqs=4, num_pages=13, max_model_len=128)
    jeng = JEngine(jcfg, params, **kw)
    teng = TEngine(tcfg, model, device="cpu", **kw)
    jreqs = jeng.generate([JRequest(prompt=list(p), max_new_tokens=24)
                           for p in prompts])
    treqs = teng.generate([TRequest(prompt=list(p), max_new_tokens=24)
                           for p in prompts])
    assert all(r.state is State.FINISHED for r in treqs)
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    assert [r.prompt for r in treqs] == [r.prompt for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.step_idx == jeng.step_idx
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.device_calls) == dict(jeng.device_calls)
    assert any(len(r.prompt) > n for r, n in zip(treqs, lens)), \
        "no request was preempted"


def test_prefill_cache_view_starts_empty(xlstm):
    _, tcfg, _, model = xlstm
    eng = TEngine(tcfg, model, device="cpu", max_seqs=2, num_pages=8,
                  max_model_len=64)
    eng.cache["mlstm"]["m"].fill_(3.0)  # a used slot
    view = eng._prefill_cache_view(4)
    assert set(view) == {"mlstm", "slstm"}
    fresh = TM.make_cache(tcfg, max_seqs=4, num_pages=8, device="cpu")
    for group, leaves in fresh.items():
        for name, t in leaves.items():
            assert torch.equal(view[group][name], t), (group, name)


def test_engine_refuses_chunked_prefill(xlstm):
    _, tcfg, _, model = xlstm
    with pytest.raises(AssertionError, match="page-addressable"):
        TEngine(tcfg, model, device="cpu", enable_chunked_prefill=True)
    with pytest.raises(ValueError, match="packed step"):
        TM.apply_unified(model, {}, {})


def test_serve_launcher_runs_xlstm_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-350m", "--reduced", "--device", "cpu", "--num-requests",
         "4", "--max-new-tokens", "3", "--max-seqs", "2", "--rate", "2"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    assert "dispatch: {}" in out.stdout
    assert "'prefill':" in out.stdout and "'decode':" in out.stdout
