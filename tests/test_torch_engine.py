"""The port's packed `Engine(device="cpu")` against the JAX packed, fused
`Engine` on serving-harness traces (reduced smollm-135m, fp32, greedy):
token-for-token identical outputs, and identical `launched_token_slots`
and `dispatch_counts` (both come from the same host-side packing and
heuristics code)."""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request as TRequest, State


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["smollm-135m"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["smollm-135m"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in lens]


def _run_both(models, prompts, *, max_new_tokens, backend="xla", **kw):
    jcfg, tcfg, params, model = models
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256, **kw)
    jeng = JEngine(jcfg, params, backend=backend, packed_attention=True,
                   fused_sampling=True, **eng_kw)
    teng = TEngine(tcfg, model, device="cpu", **eng_kw)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=max_new_tokens)
             for p in prompts]
    treqs = [TRequest(prompt=list(p), max_new_tokens=max_new_tokens)
             for p in prompts]
    jeng.generate(jreqs)
    teng.generate(treqs)
    assert all(r.state is State.FINISHED for r in treqs)
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    return jeng, teng, jreqs, treqs


def _assert_same(jeng, teng, jreqs, treqs):
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert a.output == b.output, (i, a.output, b.output)
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    assert teng.device_calls["unified"] == teng.step_idx


def test_engine_matches_reference_mixed_lengths(models):
    """Six prompts of mixed lengths through four slots: admission waves,
    decode-heavy steps (segmented) and mixed steps (gqa)."""
    prompts = _prompts(models[1].vocab_size, [5, 40, 17, 70, 3, 33])
    res = _run_both(models, prompts, max_new_tokens=6)
    _assert_same(*res)
    variants = {v for _, v in res[1].dispatch_counts}
    assert variants == {"gqa", "segmented"}


def test_engine_matches_reference_chunked_prefill(models):
    """A 32-token budget splits the long prompts into resumed chunks."""
    prompts = _prompts(models[1].vocab_size, [90, 12, 47, 5], seed=1)
    res = _run_both(models, prompts, max_new_tokens=5,
                    enable_chunked_prefill=True, max_prefill_tokens=32)
    _assert_same(*res)
    assert res[1].prefilled_tokens == sum(map(len, prompts))


def test_engine_matches_reference_pallas_backend(models):
    prompts = _prompts(models[1].vocab_size, [9, 21, 4], seed=2)
    res = _run_both(models, prompts, max_new_tokens=3, backend="pallas")
    _assert_same(*res)


def test_engine_rejects_oversized_request(models):
    _, tcfg, _, model = models
    eng = TEngine(tcfg, model, device="cpu", max_seqs=2, num_pages=16,
                  max_model_len=32)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request(TRequest(prompt=[1] * 30, max_new_tokens=8))
