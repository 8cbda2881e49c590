"""The port's hybrid family (zamba2) and padded per-kind step against the
JAX reference on the CPU, on `reduced(ARCHS["zamba2-1.2b"])` in fp32 with
the weights of `M.init(cfg, key(0))`:

  * `apply_prefill` (ragged rows) then two `apply_decode` steps (the
    second with a dead slot) against `M.apply_prefill` / `M.apply_decode`:
    logits and every cache leaf at atol / rtol 1e-4;
  * prefill(S+1) == prefill(S) + decode, as tests/test_models_smoke.py
    checks the reference (2e-4);
  * the port's `Engine` token for token against the JAX `Engine` on the
    prompts of tests/test_serving_engine.py::test_engine_ssm_archs, with
    identical dispatch choices, launched token rows and device calls;
  * reduced smollm-135m under `Engine(packed_attention=False)` token for
    token against the JAX padded engine.
"""
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


def _build(arch):
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def zamba():
    return _build("zamba2-1.2b")


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _assert_cache_equal(tcache, jcache):
    for group, leaves in jcache.items():
        for name, want in leaves.items():
            got = tcache[group][name]
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"{group}.{name}", **TOL)


def test_layout_and_cache_match_reference(zamba):
    jcfg, tcfg, _, model = zamba
    assert TM.hybrid_layout(tcfg) == JM.hybrid_layout(jcfg)
    assert TM.attn_layer_count(tcfg) == JM.attn_layer_count(jcfg)
    assert len(model.mamba) == JM.hybrid_layout(jcfg)[0]
    jc = JM.make_cache(jcfg, max_seqs=3, num_pages=5)
    tc = TM.make_cache(tcfg, max_seqs=3, num_pages=5, device="cpu")
    assert {g: {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for n, t in leaves.items()} for g, leaves in tc.items()} == \
        {g: {n: (t.shape, str(t.dtype)) for n, t in leaves.items()}
         for g, leaves in jc.items()}


def test_prefill_then_decode_match_reference(zamba):
    jcfg, tcfg, params, model = zamba
    b, s, ps = 2, 32, jcfg.page_size
    np_ = 4
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)[:, ::-1]
    pt = np.ascontiguousarray(pt)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, size=(b, s + 2)).astype(np.int32)
    qlens = np.asarray([s, 21], np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jcache = JM.make_cache(jcfg, max_seqs=b, num_pages=b * np_ + 1)
    tcache = TM.make_cache(tcfg, max_seqs=b, num_pages=b * np_ + 1,
                           device="cpu")
    jb, tb = _both({"inputs": tokens[:, :s], "positions": pos,
                    "page_table": pt, "context_lens": qlens,
                    "query_lens": qlens})
    jl, jcache = JM.apply_prefill(jcfg, params, jcache, jb)
    tl, tcache = TM.apply_prefill(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(tcache, jcache)
    ctx = qlens.copy()
    for step, live in enumerate(([True, True], [True, False])):
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


def test_prefill_decode_consistency(zamba):
    """prefill(S+1) == prefill(S) + decode(1) inside the port."""
    _, tcfg, _, model = zamba
    b, s = 2, 24
    np_ = (s + 1) // tcfg.page_size + 1
    pt = torch.arange(1, 1 + b * np_, dtype=torch.int32).reshape(b, np_)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(b, s + 1)))
    pos = TM.default_positions(tcfg, b, s + 1)

    def prefill(n):
        cache = TM.make_cache(tcfg, max_seqs=b, num_pages=b * np_ + 2,
                              device="cpu")
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


def _run_engines(built, prompts, *, max_new_tokens, with_requests=False,
                 **kw):
    jcfg, tcfg, params, model = built
    jeng = JEngine(jcfg, params, **kw)
    teng = TEngine(tcfg, model, device="cpu", **kw)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=max_new_tokens)
             for p in prompts]
    treqs = [TRequest(prompt=list(p), max_new_tokens=max_new_tokens)
             for p in prompts]
    jeng.generate(jreqs)
    teng.generate(treqs)
    assert all(r.state is State.FINISHED for r in treqs)
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert a.output == b.output, (i, a.output, b.output)
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    assert dict(teng.device_calls) == dict(jeng.device_calls)
    if with_requests:
        return teng, treqs, jeng, jreqs
    return teng


def test_engine_matches_reference(zamba):
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, zamba[0].vocab_size, size=n)))
               for n in (12, 20, 7)]
    teng = _run_engines(zamba, prompts, max_new_tokens=4, max_seqs=2,
                        num_pages=32, max_model_len=128)
    assert not teng._packed
    assert teng.device_calls["prefill"] > 0 and "unified" not in \
        teng.device_calls


def test_dense_padded_engine_matches_reference():
    built = _build("smollm-135m")
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, built[0].vocab_size, size=n)))
               for n in (5, 40, 17, 70, 3)]
    teng = _run_engines(built, prompts, max_new_tokens=5, max_seqs=4,
                        num_pages=64, max_model_len=256,
                        packed_attention=False)
    assert not teng._packed
    assert {phase for phase, _ in teng.dispatch_counts} == {"prefill",
                                                             "decode"}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "smollm-135m"])
def test_padded_engine_matches_reference_under_preemption(zamba, arch):
    """13 pages of 16 (12 usable) for four requests that need ~18: the
    padded step preempts decoding requests (their output folds into the
    prompt) and prefills them again.  Tokens, steps, launched token rows,
    dispatch and device calls equal the reference's, and no page leaks;
    zamba2, and smollm on the padded step."""
    built = zamba if arch == "zamba2-1.2b" else _build(arch)
    lens = (40, 33, 47, 20)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, built[0].vocab_size, size=n)))
               for n in lens]
    kw = {"packed_attention": False} if arch == "smollm-135m" else {}
    teng, treqs, jeng, jreqs = _run_engines(
        built, prompts, max_new_tokens=24, max_seqs=4, num_pages=13,
        max_model_len=128, with_requests=True, **kw)
    assert [r.prompt for r in treqs] == [r.prompt for r in jreqs]
    assert teng.step_idx == jeng.step_idx
    assert any(len(r.prompt) > n for r, n in zip(treqs, lens)), \
        "no request was preempted"


def test_padded_engine_rejects_what_is_not_ported(zamba):
    _, tcfg, _, model = zamba
    with pytest.raises(AssertionError, match="page-addressable"):
        TEngine(tcfg, model, device="cpu", enable_chunked_prefill=True)
    with pytest.raises(ValueError, match="packed step"):
        TM.apply_unified(model, {}, {})
