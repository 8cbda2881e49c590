"""The port's tensor-parallel serving (`serving/executor.py`, `Engine(tp=)`)
against the JAX engine, case by case after tests/test_mesh_serving.py.

Head parallelism changes where head blocks are computed, never what
tokens come out: the reference's mixed chunked + prefix-cached +
preempting trace runs through the JAX engine at tp 1 in this process and
through the port at tp 2 and tp 4 in four gloo ranks on the CPU (started
once for the module by `spawn_ranks`; each rank imports only torch and
repro_torch, tests/torch_ranks.py).  Every rank's tokens equal the JAX
engine's, every rank makes one unified call a step, and the port's
logits at tp are within 1e-5 of its own tp 1 run (the ranks' QKV
products are narrower GEMMs, whose sums may round differently).  The
rest pins the KV head split, which leaves the executor cuts, the
`ShardingError` paths and the pool's per-device stats.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serving_harness as H
import torch_ranks as R
from repro.models import model as JM
from repro_torch import weights
from repro_torch.core.attention import heuristics
from repro_torch.core.paged import kv_cache as KV
from repro_torch.core.paged.allocator import RefCountedPageAllocator
from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.attention import MLAAttention
from repro_torch.serving import executor as X
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request

# reduced smollm has 2 q / 1 kv head, not tp-divisible: widen the head
# axis (same d_model) so tp 4 still holds whole GQA groups a rank
HEADS = dict(num_q_heads=8, num_kv_heads=4)
MIXED_ENGINE = dict(max_seqs=2, num_pages=8, max_model_len=128,
                    enable_chunked_prefill=True, enable_prefix_caching=True,
                    max_prefill_tokens=16)
CYCLE = [5, 9, 17, 3]
LOGIT_ATOL = 1e-5


def _traces(cfg):
    """The reference's mixed trace (prompts of 58 and 50 tokens from
    default_rng(3), 8 new), the spec tests' repetitive trace at draft_k 3,
    and the mixed prompts unchunked for the fused-qkv model."""
    rng = np.random.default_rng(3)
    mixed = [list(map(int, p))
             for p in H.make_prompts(cfg, rng, (3 * 16 + 10, 3 * 16 + 2))]
    rng = np.random.default_rng(0)
    spec = [CYCLE * 6, (CYCLE * 5)[:18],
            list(map(int, rng.integers(1, cfg.vocab_size, size=9)))]
    return {
        "mixed": dict(prompts=mixed, new=8, engine=MIXED_ENGINE),
        "spec": dict(prompts=spec, new=16,
                     engine=dict(max_seqs=4, num_pages=64, max_model_len=256,
                                 speculative=True, draft_k=3)),
        "fused": dict(prompts=mixed, new=6,
                      engine=dict(max_seqs=2, num_pages=16,
                                  max_model_len=128)),
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX model at the widened heads and its tp 1 engine on the mixed
    trace, run here while the four ranks (tests/torch_ranks.py:serve_rank)
    serve in their own processes; `ranks` is their future."""
    cfg, params = H.build_cfg_params(**HEADS)
    _, fused = H.build_cfg_params(fused_qkv=True, **HEADS)
    traces = _traces(cfg)
    np_tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    init = tmp_path_factory.mktemp("mesh") / "store"
    pool = ThreadPoolExecutor(max_workers=1)
    ranks = pool.submit(
        spawn_ranks, R.serve_rank, 4, backend="gloo", init_file=str(init),
        args=(np_tree(params), np_tree(fused), HEADS, traces))
    pool.shutdown(wait=False)
    t = traces["mixed"]
    eng = H.build_engine(cfg, params, tp=1, **t["engine"])
    run = H.run_requests(eng, t["prompts"], max_new_tokens=t["new"])
    assert run.total("preempted") > 0, "trace must exercise preemption"
    assert run.total("partial_prefills") > 0, \
        "trace must exercise chunked (resumed-prefill) steps"
    return dict(cfg=cfg, params=np_tree(params), traces=traces,
                outputs=run.outputs, ranks=ranks)


@pytest.fixture(scope="module")
def ranks(reference):
    """The four ranks' results."""
    return reference["ranks"].result()


def _one_call_a_step(run):
    assert run["device_calls"] == {"unified": run["steps"]}, run
    assert run["free_pages"] == run["num_pages"] - 1, "pages leaked"


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_differential_mixed_chunked_cached_preempt(reference, ranks, tp):
    """Every rank at tp 2 and tp 4: the JAX engine's tokens request for
    request, one unified call a step, logits within 1e-5 of the port's
    tp 1 run step for step, and the step stats' pool over tp devices."""
    tp1 = ranks[0]["tp1"]
    assert tp1["outputs"] == reference["outputs"]
    assert tp1["preempted"] > 0 and tp1["partial"] > 0
    for rank, res in enumerate(ranks):
        run = res[f"tp{tp}"]
        assert run["outputs"] == reference["outputs"], (tp, rank)
        _one_call_a_step(run)
        assert run["num_devices"] == {tp}
        assert run["steps"] == tp1["steps"]
        for step, (a, b) in enumerate(zip(run["logits"], tp1["logits"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"tp {tp} rank {rank} step "
                                               f"{step}")


def test_tp_speculative_matches_tp1(ranks):
    """draft_k 3 at tp 2 on a repetitive trace: the port's tp 1 spec
    tokens and draft stats on both pairs of ranks, drafts accepted, one
    call a step."""
    tp1 = ranks[1]["spec_tp1"]
    assert tp1["spec_stats"]["accepted"] > 0
    for rank, res in enumerate(ranks):
        run = res["spec_tp2"]
        assert run["outputs"] == tp1["outputs"], rank
        assert run["spec_stats"] == tp1["spec_stats"], rank
        _one_call_a_step(run)


def test_tp_fused_qkv_slices_local_heads(ranks):
    """A fused wqkv stays replicated and the layer slices the rank's heads
    after the projection: tp 2 gives the tp 1 tokens."""
    tp1 = ranks[2]["fused_tp1"]
    for rank, res in enumerate(ranks):
        assert res["fused_tp2"]["outputs"] == tp1["outputs"], rank
        _one_call_a_step(res["fused_tp2"])


def test_group_of_the_wrong_size(ranks):
    """tp 2 over the default group of 4 ranks names how to start ranks."""
    for res in ranks:
        msg = res["wrong_group"]
        assert "tp=2" in msg and "4 ranks" in msg, msg
        assert "spawn_ranks" in msg and "torchrun" in msg, msg


def test_uninitialised_world_error_names_the_launchers(reference):
    cfg = R.port_cfg(**HEADS)
    model = weights.from_jax_params(cfg, reference["params"], device="cpu")
    with pytest.raises(KV.ShardingError,
                       match="not initialised.*spawn_ranks.*torchrun"):
        Engine(cfg, model, device="cpu", tp=4, max_seqs=2, num_pages=8)


def _greedy(cfg, params, prompt, n, width=32):
    """The harness's dense cacheless greedy continuation in one jitted
    causal forward over a fixed-width buffer (the positions past the
    tokens cannot reach the last one's logits)."""
    fwd = jax.jit(partial(JM.forward, cfg, mode="train"))
    pos = JM.default_positions(cfg, 1, width)
    toks = list(prompt)
    for _ in range(n):
        x = jnp.asarray(toks + [0] * (width - len(toks)))[None]
        logits, _, _ = fwd(params, x, pos)
        toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
    return toks[len(prompt):]


def test_tp1_executor_is_single_device_and_matches_reference():
    """tp 1 is the engine's own path: the SingleDeviceExecutor, and the
    reference's dense greedy tokens."""
    cfg, params = H.build_cfg_params()
    tcfg = R.port_cfg()
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    eng = Engine(tcfg, model, device="cpu", max_seqs=4, num_pages=64,
                 max_model_len=256)
    assert type(eng.executor) is X.SingleDeviceExecutor
    assert eng.executor.describe() == {"tp": 1, "pp": 1}
    prompts = H.make_prompts(cfg, np.random.default_rng(7), (13, 5))
    reqs = [Request(prompt=list(map(int, p)), max_new_tokens=6)
            for p in prompts]
    eng.generate(reqs)
    for p, r in zip(prompts, reqs):
        assert r.output == _greedy(cfg, params, p, 6)


def test_kv_head_shard_round_trip(ranks):
    """Each rank allocates only its own pool, a contiguous block of the
    head axis in rank order (`shard_cache_specs`: dim 1 cut, the rest
    whole): after the mixed trace, the tp 2 and tp 4 ranks' pools,
    concatenated in rank order, are the tp 1 pool (within the logits'
    1e-5: narrower K / V products may round differently)."""
    specs = KV.make_kv_cache_specs(2, 8, 1, 6, 4, 16, 16, torch.float32)
    local = KV.shard_cache_specs(specs, 4)
    for name in ("k_pages", "v_pages"):
        assert local[name] == ((2, 2, 1, 6, 4, 16), torch.float32)
    full = ranks[0]["tp1"]["pool"]
    for tp, groups in ((2, [(0, 1), (2, 3)]), (4, [(0, 1, 2, 3)])):
        for group in groups:
            for name, want in full.items():
                parts = [ranks[r][f"tp{tp}"]["pool"][name] for r in group]
                hkv = want.shape[1]
                assert all(p.shape == want.shape[:1] + (hkv // tp,)
                           + want.shape[2:] for p in parts), (tp, name)
                np.testing.assert_allclose(
                    np.concatenate(parts, axis=1), want, rtol=0,
                    atol=LOGIT_ATOL, err_msg=f"tp {tp} {name} {group}")


@pytest.mark.parametrize("fused", [False, True])
def test_serve_params_shard_only_qkv_heads(reference, fused):
    """Only wq / wk / wv weights and biases are cut, on their last (head)
    dim, to the rank's whole-head block; a fused wqkv stays whole."""
    cfg = R.port_cfg(qkv_bias=True, fused_qkv=fused, **HEADS)
    model = weights.init_random(cfg, 0, device="cpu")
    full = {n: p.clone() for n, p in model.named_parameters()}
    specs = PS.serve_param_specs(model, tp=4)
    sharded = {n for n, d in specs.items() if d is not None}
    if fused:
        assert not sharded
    else:
        assert sharded and all(
            set(n.split(".")) & set(PS.SERVE_HEAD_PARALLEL) for n in sharded)
        assert {n.rsplit(".", 1)[1] for n in sharded} == {"w", "b"}
        assert all(specs[n] == full[n].ndim - 1 for n in sharded)
    PS.shard_serve_params(model, 4, 3)
    for n, p in model.named_parameters():
        if n in sharded:
            w = full[n].shape[-1] // 4
            assert torch.equal(p, full[n][..., 3 * w:])
        else:
            assert torch.equal(p, full[n]), n


def test_sharding_errors_in_process(reference):
    cfg = R.port_cfg()  # 2 q / 1 kv head
    model = weights.init_random(cfg, 0, device="cpu")
    # head counts not divisible by tp (checked before the group)
    with pytest.raises(KV.ShardingError, match="num_kv_heads=1"):
        Engine(cfg, model, device="cpu", tp=2)
    # the padded per-kind step never runs under a split
    with pytest.raises(KV.ShardingError, match="packed"):
        Engine(cfg, model, device="cpu", tp=2, packed_attention=False)
    # CUDA graphs of a step with its all-gather inside
    wide = R.port_cfg(**HEADS)
    with pytest.raises(KV.ShardingError, match="cuda_graphs=False"):
        X.make_executor(wide, tp=2, max_seqs=2, fused=True, graphs=True)
    # pipeline parallelism is an interface stub
    with pytest.raises(NotImplementedError, match="pp=2"):
        X.make_executor(cfg, tp=1, pp=2, max_seqs=2, fused=True)
    # helper-level divisibility validation
    with pytest.raises(KV.ShardingError, match="num_kv_heads=3"):
        KV.local_kv_heads(3, 2)
    with pytest.raises(KV.ShardingError, match="num_q_heads=6"):
        KV.local_kv_heads(4, 4, num_q_heads=6)
    assert KV.local_kv_heads(8, 4, num_q_heads=16) == 2


def test_mla_and_padded_modes_refuse_a_split():
    """MLA has one latent KV head; the padded modes run unsplit only."""
    cfg = R.port_cfg("deepseek-v2-236b")
    mla = MLAAttention(cfg, device="cpu")
    shard = ShardCtx(size=2)
    for fwd in (mla.forward, mla.forward_prefill, mla.forward_decode):
        with pytest.raises(KV.ShardingError, match="single latent KV head"):
            fwd(None, None, None, None, {}, shard=shard)
    with pytest.raises(KV.ShardingError, match="packed"):
        Engine(cfg, weights.init_random(cfg, 0, device="cpu"), device="cpu",
               tp=2)
    attn = weights.init_random(R.port_cfg(**HEADS), 0,
                               device="cpu").decoder_blocks()[0].attn
    for fwd, mode in ((attn.forward_prefill, "prefill"),
                      (attn.forward_decode, "decode")):
        with pytest.raises(KV.ShardingError, match=f"mode='{mode}'"):
            fwd(None, None, None, None, {}, shard=shard)


def test_mesh_stats_aggregate_and_per_device():
    alloc = RefCountedPageAllocator(16, 4)
    pages = alloc.allocate(3)
    base = alloc.stats()
    agg = alloc.mesh_stats(4)
    assert agg["num_devices"] == 4 and len(agg["per_device"]) == 4
    for k, v in base.items():
        assert agg[k] == 4 * v, (k, agg[k], v)
    for d, dev in enumerate(agg["per_device"]):
        assert dev["device"] == d
        assert {k: dev[k] for k in base} == base
    one = alloc.mesh_stats(1)
    assert {k: one[k] for k in base} == base
    alloc.free(pages)


def test_batch_profile_mesh_fingerprint():
    from repro_torch.obs import Telemetry
    from repro_torch.obs.clock import FakeClock

    p = heuristics.BatchProfile(num_seqs=2, max_context=64, group=2,
                                page_size=16, tp=4)
    assert p.tp == 4
    assert heuristics.BatchProfile(num_seqs=2, max_context=64, group=2,
                                   page_size=16).tp == 1
    tel = Telemetry(clock=FakeClock())
    tel.set_arch(tp=4)
    tel.record_launch("unified", p, heuristics.KernelConfig("gqa"),
                      0.0, 1.0, compiled=False, tokens=32,
                      grid_phase="unified")
    grid = tel.latency_grid()
    assert grid["arch"]["tp"] == 4
    assert grid["entries"][0]["profile"]["tp"] == 4
