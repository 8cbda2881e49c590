"""The port's executable cache against the reference's, and the pieces
that let the card capture the packed step and the padded decode step into
CUDA graphs, all on the CPU (reduced models, fp32, greedy unless stated):

  * the port's `compile_events` equal the JAX engine's on the same trace,
    key for key in the same order, `KernelConfig` compared field by field:
    packed smollm-135m with chunked prefill; a loaded tree that flips the
    unified step between gqa and segmented; the padded step of zamba2,
    xlstm and smollm.  On the CPU every entry is eager and nothing is
    captured; the tokens equal the reference's as well;
  * the static-shape `write_pages` equals the reference's bit for bit with
    negative, out-of-range and trash slots, and page 0 stays unchanged;
  * the split sampler (host noise into a static buffer, `sample_tokens`
    on device parameters) gives exactly the tokens of the one-call
    sampler it replaced, for greedy and for sampled rows;
  * a counted capture leaves the launch counters as they were, and its
    delta added once per replay equals what the eager runs add.
"""
import dataclasses
import gc
import importlib
import json
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.attention import heuristics as jheur
from repro.core.paged import kv_cache as jkv
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import kernels as tkernels
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.attention import heuristics as theur
from repro_torch.core.paged import kv_cache as tkv
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.models import sampling as TS
from repro_torch.serving import cuda_graphs
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request as TRequest, State


def _build(arch):
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def smollm():
    return _build("smollm-135m")


def _events(eng):
    """compile_events with each KernelConfig as a dict of its fields."""
    return [(kind, b, s, None if k is None else dataclasses.asdict(k))
            for kind, b, s, k in eng.compile_events]


def _run_both(built, lens, *, seed, max_new_tokens=5, **kw):
    """The same prompts through the JAX engine and the port's (CPU); the
    tokens must agree, every port entry must be eager.  Returns both
    engines."""
    jcfg, tcfg, params, model = built
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size, size=n)))
               for n in lens]
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256) | kw
    jeng = JEngine(jcfg, params, **eng_kw)
    teng = TEngine(tcfg, model, device="cpu", **eng_kw)
    jreqs = jeng.generate([JRequest(prompt=list(p),
                                    max_new_tokens=max_new_tokens)
                           for p in prompts])
    treqs = teng.generate([TRequest(prompt=list(p),
                                    max_new_tokens=max_new_tokens)
                           for p in prompts])
    assert all(r.state is State.FINISHED for r in treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(isinstance(f, cuda_graphs.EagerStep)
               for f in teng._compiled.values())
    assert teng.graph_stats == {"captures": 0, "replays": 0,
                                "capture_s": 0.0}
    assert list(teng._compiled) == teng.compile_events
    return jeng, teng


def test_compile_events_match_reference_packed_chunked(smollm):
    """A 32-token budget: decode-only, mixed and resumed-chunk steps in
    several token buckets, on both default configs."""
    jeng, teng = _run_both(smollm, (90, 12, 47, 5, 33), seed=1,
                           enable_chunked_prefill=True, max_prefill_tokens=32)
    assert _events(teng) == _events(jeng)
    assert {e[0] for e in teng.compile_events} == {"unified"}
    assert len(teng.compile_events) >= 4
    assert teng.device_calls["unified"] == teng.step_idx


def test_compile_events_match_reference_loaded_tree(smollm, tmp_path):
    """A loaded unified tree sends decode-only steps to segmented (4
    segments) and mixed steps to gqa: one key per (bucket, config), in the
    reference's order."""
    seg = {"variant": "segmented", "tile": None, "num_segments": 4,
           "block_q": 16}
    gqa = {"variant": "gqa", "tile": None, "num_segments": 8, "block_q": 16}
    path = tmp_path / "tree.json"
    path.write_text(json.dumps({
        "decode_tree": [[{}, gqa]], "prefill_tree": [[{}, gqa]],
        "unified_tree": [[{"decode_share_ge": 0.999}, seg], [{}, gqa]]}))
    jheur.load(str(path))
    theur.load(str(path))
    try:
        jeng, teng = _run_both(smollm, (9, 17, 30), seed=6, max_new_tokens=8)
    finally:
        jheur.reset()
        theur.reset()
    assert _events(teng) == _events(jeng)
    variants = {e[3].variant for e in teng.compile_events}
    assert variants == {"gqa", "segmented"}
    assert len(set(teng.compile_events)) == len(teng.compile_events)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m",
                                  "smollm-135m"])
def test_compile_events_match_reference_padded(arch):
    """The padded per-kind step: ("prefill", b, s, kcfg) per fresh-prompt
    bucket (eager in the port) and ("decode", max_seqs, 1, kcfg) per
    config (kcfg None for xlstm, which has no attention layer)."""
    built = _build(arch)
    kw = {"packed_attention": False} if arch == "smollm-135m" else {}
    jeng, teng = _run_both(built, (12, 20, 7, 40), seed=4, max_seqs=2,
                           num_pages=32, max_model_len=128, **kw)
    assert _events(teng) == _events(jeng)
    kinds = [e[0] for e in teng.compile_events]
    assert set(kinds) == {"prefill", "decode"}
    assert all(e[1:3] == (2, 1) for e in teng.compile_events
               if e[0] == "decode")
    if arch == "xlstm-350m":
        assert all(e[3] is None for e in teng.compile_events)


# ---------------------------------------------------------------------------
# the KV write with a static shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pools", [1, 2])
def test_write_pages_matches_reference_bit_for_bit(pools):
    """Live slots off page 0, plus negative slots (one wrapping into range
    from the pool's end, as the reference's indexing does, and two below
    it), the trash slot and slots past it: the pages equal the reference's
    exactly, and page 0 keeps its bits."""
    rng = np.random.default_rng(3)
    hkv, p, ps, d, b_loc, t = 2, 6, 4, 8, 2, 7
    s = pools * b_loc
    trash = p * ps
    pages = rng.standard_normal((hkv, pools, p, ps, d)).astype(np.float32)
    new = rng.standard_normal((s, t, hkv, d)).astype(np.float32)
    slots = np.concatenate([ps + rng.permutation(trash - ps)[: b_loc * t]
                            for _ in range(pools)]).reshape(s, t)
    slots[0, 1] = trash
    slots[0, 2] = -1 - trash  # below -slots_per_pool: dropped
    slots[-1, 0] = trash + 7
    slots[-1, 3] = -1000
    slots[-1, -1] = trash
    wrapped = slots[0, 4] - trash  # the same slot, counted from the end
    slots[0, 4] = wrapped
    slots = slots.astype(np.int32)
    want = np.asarray(jkv.write_pages(jnp.asarray(pages), jnp.asarray(new),
                                      jnp.asarray(slots)))
    got = tkv.write_pages(torch.from_numpy(pages.copy()),
                          torch.from_numpy(new), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, :, 0], pages[:, :, 0])
    assert not np.array_equal(got.numpy(), pages)


def test_write_pages_all_dropped_keeps_every_bit():
    """No live row (every slot trash, past it or below -slots_per_pool):
    the pages keep every bit, -0.0 included."""
    pages = np.random.default_rng(4).standard_normal(
        (2, 1, 3, 4, 8)).astype(np.float32)
    pages[0, 0, 0, 0, :2] = -0.0
    slots = np.array([[12, 13, -13, 500, 12]], np.int32)
    new = np.ones((1, 5, 2, 8), np.float32)
    got = tkv.write_pages(torch.from_numpy(pages.copy()),
                          torch.from_numpy(new), torch.from_numpy(slots))
    want = np.asarray(jkv.write_pages(jnp.asarray(pages), jnp.asarray(new),
                                      jnp.asarray(slots)))
    assert got.numpy().tobytes() == pages.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the split sampler
# ---------------------------------------------------------------------------


def _one_call_sampler(logits, seed, temps, topp, topk, streams, ngen):
    """The sampler as one call, as it was before the split: host arrays
    in, noise only for rows with temperature > 0, none at all when every
    row is greedy."""
    hot = [i for i, t in enumerate(temps) if t > 0]
    noise = TS.gumbel_noise(seed, streams, ngen, logits.shape[-1], "cpu",
                            rows=hot) if hot else None
    return TS.sample_tokens(
        logits, torch.as_tensor(temps, dtype=torch.float32),
        torch.as_tensor(topp, dtype=torch.float32),
        torch.as_tensor(topk, dtype=torch.int32), noise)


def test_split_sampler_gives_the_one_call_tokens():
    """Three steps through one static noise buffer, as the packed step
    runs them: sampled rows, then all greedy (the buffer still holds the
    last draw until it is zeroed), then other rows sampled.  Every token
    equals the one-call sampler's (exact: same noise, same ops)."""
    s, v, seed = 8, 257, 11
    rng = np.random.default_rng(0)
    noise = torch.full((s, v), 9.0)  # stale contents
    noisy = True
    steps = [
        ([0.0, 0.7, 0.0, 1.3, 0.0, 0.0, 2.0, 0.0], [1, .9, 1, .5, 1, 1, .8, 1],
         [0, 5, 0, 0, 0, 0, 40, 0]),
        ([0.0] * s, [1.0] * s, [0] * s),
        ([0.5, 0.0, 0.0, 0.0, 0.9, 0.0, 0.0, 1.0], [.7, 1, 1, 1, .95, 1, 1, 1],
         [3, 0, 0, 0, 0, 0, 0, 2]),
    ]
    for k, (temps, topp, topk) in enumerate(steps):
        logits = torch.from_numpy(
            rng.standard_normal((s, v)).astype(np.float32) * 3)
        temps = np.asarray(temps, np.float32)
        topp = np.asarray(topp, np.float32)
        topk = np.asarray(topk, np.int32)
        streams = np.arange(100, 100 + s, dtype=np.int64)
        ngen = np.full((s,), k + 2, np.int64)
        want = _one_call_sampler(logits, seed, temps, topp, topk, streams,
                                 ngen)
        hot = TS.hot_rows(temps)  # the host part, outside the step
        if hot or noisy:
            TS.gumbel_noise(seed, streams, ngen, v, "cpu", rows=hot,
                            out=noise)
        noisy = bool(hot)
        got = TS.sample_tokens(logits, torch.from_numpy(temps),
                               torch.from_numpy(topp),
                               torch.from_numpy(topk), noise)
        assert torch.equal(got, want), (k, got, want)
        cold = [i for i in range(s) if i not in hot]
        assert not noise[cold].any()
        if not hot:
            assert torch.equal(want, logits.argmax(-1).to(torch.int32))


def test_packed_engine_samples_as_the_one_call_sampler(smollm):
    """The packed engine on the CPU with sampled requests (temperature,
    top-k, top-p) and greedy ones: each step's tokens equal the one-call
    sampler on that step's logits and sampling rows."""
    _, tcfg, _, model = smollm
    eng = TEngine(tcfg, model, device="cpu", max_seqs=4, num_pages=64,
                  max_model_len=256, debug_logits=True, seed=5)
    rng = np.random.default_rng(2)
    # the sampled requests stop first: the last steps are all greedy
    kinds = [dict(temperature=0.8, top_k=20, top_p=0.9), {},
             dict(temperature=1.2, max_new_tokens=2),
             dict(temperature=0.5, top_p=0.5)]
    for n, kw in zip((9, 30, 4, 17), kinds):
        eng.add_request(TRequest(
            prompt=list(map(int, rng.integers(1, tcfg.vocab_size, size=n))),
            **{"max_new_tokens": 3} | kw))
    eng.add_request(TRequest(prompt=[5, 6, 7], max_new_tokens=6))
    draws, batches = [], []
    launch, consume = eng._launch_unified, eng._consume_unified

    def record(batch, flight, prev_toks):
        batches.append(batch)
        launch(batch, flight, prev_toks)

    def check(pack, toks):  # the launch's host ids, before they are used
        batch = batches.pop()
        temps, _, _, streams, ngen = pack.sampling
        want = _one_call_sampler(eng.last_step_logits, eng.seed, temps,
                                 batch["top_p"], batch["top_k"], streams,
                                 ngen)
        np.testing.assert_array_equal(toks, want.numpy())
        draws.append(len(TS.hot_rows(temps)))
        consume(pack, toks)

    eng._launch_unified, eng._consume_unified = record, check
    while eng.sched.has_work:
        eng.step()
    assert draws[0] == 3 and 2 in draws and draws[-1] == 0


# ---------------------------------------------------------------------------
# launch counters through capture and replay
# ---------------------------------------------------------------------------


def test_kernel_counters_cover_every_wrapper_counter():
    """Every LAUNCHES / KERNEL_LAUNCHES dict of the kernel modules is one
    that capture and replay keep in step."""
    found = []
    for info in pkgutil.walk_packages(tkernels.__path__,
                                      tkernels.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name in ("LAUNCHES", "KERNEL_LAUNCHES"):
            if isinstance(getattr(mod, name, None), dict):
                found.append(getattr(mod, name))
    ids = {id(c) for c in cuda_graphs.kernel_counters()}
    assert len(found) == len(ids) == 16
    assert {id(c) for c in found} == ids


def test_counted_capture_replays_add_what_eager_runs_add():
    """A step body that counts like the wrappers (a folded C3 decode and
    a Q-Block prefill): the counted run (the capture) leaves the counters
    untouched, and its delta added per replay gives what eager runs
    give."""
    def step():
        K.LAUNCHES["paged_decode_segmented"] += 1
        K.LAUNCHES["segment_reduce"] += 1
        K.KERNEL_LAUNCHES["decode_stream_seg_merge_kernel"] += 1
        K.LAUNCHES["paged_prefill_qblock"] += 2
        K.KERNEL_LAUNCHES["prefill_kernel"] += 2
        return "out"

    counters = cuda_graphs.kernel_counters()
    saved = [dict(c) for c in counters]
    try:
        K.reset_launches()
        step()  # the warm-up runs eagerly and counts
        for _ in range(3):
            step()
        eager = [dict(c) for c in counters]
        K.reset_launches()
        step()
        before = [dict(c) for c in counters]
        out, delta = cuda_graphs.counted(step)
        assert out == "out"
        assert [dict(c) for c in counters] == before
        for _ in range(3):
            cuda_graphs.add_counts(delta)
        assert [dict(c) for c in counters] == eager
        assert eager[0]["paged_prefill_qblock"] == 8
    finally:
        for c, s in zip(counters, saved):
            c.update(s)


def test_counted_restores_counters_when_the_capture_raises():
    counters = cuda_graphs.kernel_counters()
    before = [dict(c) for c in counters]

    def fails():
        K.LAUNCHES["paged_decode"] += 5
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cuda_graphs.counted(fails)
    assert [dict(c) for c in counters] == before


@pytest.mark.parametrize("enabled", [True, False])
def test_gc_paused_restores_the_collector(enabled):
    """`gc_paused` turns the cyclic collector off for its block (a
    collection inside a capture could destroy another engine's graphs)
    and restores its state, also when the block raises."""
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with cuda_graphs.gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError):
            with cuda_graphs.gc_paused():
                raise RuntimeError("capture failed")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
