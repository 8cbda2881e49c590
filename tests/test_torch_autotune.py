"""The port's autotune subsystem (`repro_torch.autotune`) on the CPU:

  * the tree fit is the reference's, bit for bit: `fit_tree`, `flatten`,
    `to_listing` and `regret_report` of both packages on identical
    `SweepResult`s (seeded numpy timings with ties and infs);
  * `refit_from_telemetry` writes the reference's payload from one
    latency-grid JSON when both packages' `measure` are patched to one
    shared function; the online `RefitDaemon` of both packages computes
    the same payload from one grid;
  * the Hopper cost model keeps the paper's structure (the reference's
    tests/test_autotune.py, with its own numbers): C3 wins small-batch
    long-context decode and loses large-batch short-context decode; C1
    never beats C2 (on the port's decode kernel a KV head's query heads
    are one block's rows, so they cost the same); an fp32 prefill over
    the 227 KB a block may use is inf, as the wrapper refuses it; a bad
    tile is inf; the phases are costed apart and the unified launch is
    their sum; the chunk roofline never shrinks with the context;
  * export -> the port's `heuristics.load` -> dispatch round-trips;
  * `use_hardware=True` raises without a card; on the card only a
    `LaunchLimitError` prices a configuration at inf.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.autotune import costmodel as jcm
from repro.autotune import microbench as jmb
from repro.autotune import tune as jtune
from repro.core.attention import heuristics as jheur
from repro.obs import RefitDaemon as JRefitDaemon, Telemetry as JTelemetry
from repro_torch.autotune import costmodel as tcm
from repro_torch.autotune import microbench as tmb
from repro_torch.autotune import tune as ttune
from repro_torch.core.attention import heuristics as theur
from repro_torch.kernels._common import LaunchLimitError
from repro_torch.obs import RefitDaemon as TRefitDaemon
from repro_torch.obs import Telemetry as TTelemetry

SPACES = ("DECODE_SPACE", "PREFILL_SPACE", "UNIFIED_SPACE")
# a refit's diagnostics that divide by the card's rates (roofline/hw.py):
# the reference's are a TPU's, the port's an H100's
HW_STATS = ("host_overhead_s_est", "device_time_fraction")


@pytest.fixture(autouse=True)
def _reset_trees():
    yield
    jheur.reset()
    theur.reset()


def _results(mb, cm, space, seed):
    """SweepResults of `mb` over the reference grid's scenarios (rebuilt
    as `cm.Scenario`s) with seeded timings: a coarse grid of values (so
    configs tie) and some infs."""
    rng = np.random.default_rng(seed)
    out = []
    for sc in jmb.scenario_grid(seed=seed):
        t = rng.integers(1, 6, size=len(space)).astype(float) * 1e-4
        t[rng.random(len(space)) < 0.1] = math.inf
        t[rng.integers(len(space))] = 1e-4  # every scenario a finite best
        out.append(mb.SweepResult(
            cm.Scenario(**dataclasses.asdict(sc)),
            {i: float(v) for i, v in enumerate(t)}))
    return out


def test_scenario_grid_and_spaces_are_the_reference_s():
    for seed in (0, 3):
        assert [dataclasses.asdict(s) for s in tmb.scenario_grid(seed=seed)] \
            == [dataclasses.asdict(s) for s in jmb.scenario_grid(seed=seed)]
    for name in SPACES:
        assert [dataclasses.astuple(c) for c in getattr(tmb, name)] \
            == [dataclasses.astuple(c) for c in getattr(jmb, name)]
    cut = dict(batch_sizes=(1, 8, 64), max_lens=(128, 1024, 4096))
    assert len(tmb.scenario_grid(seed=0, **cut)) == 27


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_fit_is_the_reference_s(space, seed):
    jspace, tspace = getattr(jmb, space), getattr(tmb, space)
    jres = _results(jmb, jcm, jspace, seed)
    tres = _results(tmb, tcm, tspace, seed)
    for kw in (dict(), dict(max_depth=2, min_leaf=2)):
        jtree = jtune.fit_tree(jres, jspace, **kw)
        ttree = ttune.fit_tree(tres, tspace, **kw)
        assert ttune.flatten(ttree, tspace) == jtune.flatten(jtree, jspace)
        assert ttune.to_listing(ttree, tspace) \
            == jtune.to_listing(jtree, jspace)
        assert ttune.regret_report(tres, tspace, ttree) \
            == jtune.regret_report(jres, jspace, jtree)


def _grid():
    """A latency grid as a packed engine's telemetry records it, written
    by the port's Telemetry (the reference's gives the same, see
    tests/test_torch_obs.py), with costs on its entries."""
    tel = TTelemetry()
    tel.set_arch(num_q_heads=9, num_kv_heads=3, head_dim=64, page_size=16,
                 tp=1)
    rng = np.random.default_rng(5)
    cfgs = [theur.KernelConfig("gqa"),
            theur.KernelConfig("segmented", num_segments=4),
            theur.KernelConfig("gqa", tile=8, block_q=32)]
    for i in range(40):
        prof = theur.BatchProfile(
            num_seqs=int(rng.choice([1, 4, 8])),
            max_context=int(rng.choice([128, 1024, 4096])), group=3,
            page_size=16, decode_share=float(rng.choice([0.0, 0.5, 1.0])),
            avg_query_len=int(rng.choice([1, 64, 512])),
            total_tokens=int(rng.choice([8, 256, 1024])))
        phase = ("unified", "decode", "prefill")[i % 3]
        t = float(rng.uniform(1e-4, 1e-3))
        tel.record_launch(phase, prof, cfgs[i % 3], 0.0, t, compiled=False,
                          tokens=8, grid_phase=phase,
                          cost={"flops": 1e9, "bytes_accessed": 1e8})
    return tel.latency_grid()


@pytest.mark.parametrize("separate", [False, True])
def test_refit_payload_is_the_reference_s(tmp_path, monkeypatch, separate):
    grid = _grid()
    path = tmp_path / "grid.json"
    path.write_text(json.dumps(grid))

    def shared(scenario, cfg, *, unified=False, **_):
        # one function of the features both Scenario types share
        return (1e-4 * scenario.num_seqs + 1e-7 * scenario.max_context
                * (1 + cfg.num_segments) / (1 + cfg.block_q)
                + (2e-5 if unified else 0.0) + 1e-6 * (cfg.tile or 0))

    monkeypatch.setattr(jtune, "measure", shared)
    monkeypatch.setattr(ttune, "measure", shared)
    if separate:
        # the host-overhead floor divides by each package's card rates:
        # held to the port's on both sides, the payloads must agree
        for name in ("PEAK_FLOPS_BF16", "HBM_BW"):
            monkeypatch.setattr(jtune.hw, name, getattr(ttune.hw, name))
    reps = {}
    for name, mod in (("j", jtune), ("t", ttune)):
        out = tmp_path / f"{name}.json"
        rep = mod.refit_from_telemetry(
            str(path), str(out), str(tmp_path / f"{name}.py"),
            separate_host_overhead=separate)
        stats = {ph: {k: v for k, v in st.items()
                      if separate or k not in HW_STATS}
                 for ph, st in rep["phases"].items()}
        reps[name] = (json.loads(out.read_text()), stats,
                      (tmp_path / f"{name}.py").read_text())
    assert reps["t"] == reps["j"]
    assert set(reps["t"][1]) == {"unified", "decode", "prefill"}
    st = rep["phases"]["unified"]  # the port's
    assert st["host_overhead_s_est"] is not None
    assert (st["host_overhead_applied_s"] > 0) == separate


def test_refit_daemons_compute_the_same_payload(tmp_path, monkeypatch):
    """Both packages' daemons, each on a Telemetry fed the same launches,
    refit and hot-swap the same trees into their heuristics."""
    monkeypatch.setattr(jtune, "measure", lambda s, c, **k: 1e-4 * s.num_seqs
                        + 1e-6 * c.num_segments)
    monkeypatch.setattr(ttune, "measure", lambda s, c, **k: 1e-4 * s.num_seqs
                        + 1e-6 * c.num_segments)
    payloads = {}
    for name, tel_cls, daemon_cls, heur in (
            ("j", JTelemetry, JRefitDaemon, jheur),
            ("t", TTelemetry, TRefitDaemon, theur)):
        tel = tel_cls(launch_timing_interval=1)
        daemon = daemon_cls(tel, out_dir=str(tmp_path / name), min_new=3)
        for i in range(4):
            prof = heur.BatchProfile(num_seqs=2, max_context=256, group=3,
                                     page_size=16, decode_share=1.0,
                                     total_tokens=2)
            tel.record_launch("unified", prof, heur.KernelConfig("gqa"),
                              0.0, 1e-3 * (i + 1), compiled=False, tokens=8,
                              grid_phase="unified")
            daemon.on_step(None)
        payloads[name] = (daemon.report()["refits"], daemon.swaps,
                          json.loads(open(daemon.last_path).read()),
                          heur.unified_config(prof))
    assert payloads["t"][:3] == payloads["j"][:3]
    assert payloads["t"][0] == 1
    assert dataclasses.astuple(payloads["t"][3]) \
        == dataclasses.astuple(payloads["j"][3])


def _decode(bs, ctx, group=4, page=16, kv=8, d=128):
    return tcm.Scenario(num_seqs=bs, context_lens=(ctx,) * bs,
                        query_lens=(1,) * bs, num_q_heads=kv * group,
                        num_kv_heads=kv, head_dim=d, page_size=page)


def test_costmodel_keeps_the_paper_structure():
    # C3 (segmented) wins small-batch long-context decode: one block per
    # (sequence, KV head) cannot draw the card's bandwidth alone
    small_long = _decode(1, 32768)
    assert tcm.decode_time(small_long, variant="segmented", tile=16,
                           num_segments=16) \
        < 0.5 * tcm.decode_time(small_long, variant="gqa", tile=16)
    # ...and not large-batch short-context decode (its partials cost)
    big_short = _decode(128, 256)
    assert tcm.decode_time(big_short, variant="gqa", tile=16) \
        < tcm.decode_time(big_short, variant="segmented", tile=16,
                          num_segments=16)
    # C1 never beats C2: on the port's kernel they are the same blocks
    for sc in (small_long, big_short, _decode(16, 8192, group=8)):
        assert tcm.decode_time(sc, variant="gqa", tile=16) \
            == tcm.decode_time(sc, variant="baseline", tile=16)
    # a tile that does not divide the page is inf
    assert tcm.decode_time(small_long, variant="gqa", tile=32) == math.inf
    assert tcm.decode_time(_decode(1, 64, page=24), variant="gqa",
                           tile=16) == math.inf
    # prefill cost grows with context
    short = tcm.Scenario(num_seqs=4, context_lens=(1024,) * 4,
                         query_lens=(1024,) * 4, num_q_heads=32,
                         num_kv_heads=8, head_dim=128, page_size=16)
    long_ = dataclasses.replace(short, context_lens=(8192,) * 4,
                                query_lens=(8192,) * 4)
    assert tcm.prefill_time(long_, block_q=16, tile=16) \
        > tcm.prefill_time(short, block_q=16, tile=16)
    with pytest.raises(ValueError):
        tcm.decode_time(small_long, variant="nope", tile=16)


def test_costmodel_prefill_rows_and_shared_memory():
    sc = tcm.Scenario(num_seqs=4, context_lens=(1024,) * 4,
                      query_lens=(1000,) * 4, num_q_heads=9, num_kv_heads=3,
                      head_dim=64, page_size=16)
    # group 3: block_q 8 pads 24 rows to two 16-row slabs (32), block_q
    # 16 fills three exactly
    assert tcm.prefill_time(sc, block_q=8, tile=16) \
        > tcm.prefill_time(sc, block_q=16, tile=16)
    # fp32 at qwen2.5-3b's heads (group 8, D 128): 32 x 8 rows need more
    # shared memory a block than the card has, as the wrapper computes
    qwen = tcm.Scenario(num_seqs=2, context_lens=(512,) * 2,
                        query_lens=(256,) * 2, num_q_heads=16,
                        num_kv_heads=2, head_dim=128, page_size=16,
                        dtype_bytes=4)
    assert tcm._attend_smem_bytes(256, 128, 16) > 232448 \
        >= tcm._attend_smem_bytes(128, 128, 16)
    assert tcm.prefill_time(qwen, block_q=32, tile=16) == math.inf
    assert tcm.prefill_time(qwen, block_q=16, tile=16) < math.inf
    # the bf16 tensor-core prefill has no such limit
    assert tcm.prefill_time(dataclasses.replace(qwen, dtype_bytes=2),
                            block_q=64, tile=16) < math.inf


def test_costmodel_phase_split_and_unified_sum():
    mixed = tcm.Scenario(num_seqs=4, context_lens=(100, 200, 4096, 8192),
                         query_lens=(1, 1, 512, 1024), num_q_heads=32,
                         num_kv_heads=8, head_dim=128, page_size=16)
    dec, pre = tcm.split_phases(mixed)
    assert dec.context_lens == (100, 200) and pre.query_lens == (512, 1024)
    assert tcm.decode_time(mixed, variant="gqa", tile=16) \
        == tcm.decode_time(dec, variant="gqa", tile=16)
    assert tcm.prefill_time(mixed, block_q=16, tile=16) \
        == tcm.prefill_time(pre, block_q=16, tile=16)
    assert tcm.decode_time(pre, variant="gqa", tile=16) == 0.0
    assert tcm.prefill_time(dec, block_q=16, tile=16) == 0.0
    cfg = tmb.DECODE_SPACE[1]
    assert tmb.measure(mixed, cfg) == (
        tcm.decode_time(dec, variant="gqa", tile=8)
        + tcm.prefill_time(pre, block_q=16, tile=8))
    # the packed launch runs both regions' kernels one after the other
    assert tmb.measure(mixed, cfg, unified=True) == pytest.approx(
        tcm.decode_time(dec, variant="gqa", tile=8)
        + tcm.prefill_time(pre, block_q=16, tile=8))


def test_chunk_roofline_is_monotone():
    kw = dict(num_q_heads=32, num_kv_heads=8, head_dim=128, page_size=16)
    budgets = [tcm.suggest_max_prefill_tokens(target_context=t, **kw)
               for t in (128, 1024, 8192, 32768)]
    assert budgets[0] >= 16 and budgets == sorted(budgets)
    tight = tcm.suggest_max_prefill_tokens(target_context=32768,
                                           itl_slack=1.0, **kw)
    assert tight <= budgets[-1]


def _walk(node, scenario):
    while node.config_idx is None:
        node = (node.le if getattr(scenario, node.feature) <= node.threshold
                else node.gt)
    return node.config_idx


def test_export_load_dispatch_round_trip(tmp_path):
    path = tmp_path / "tree.json"
    rep = ttune.tune_and_export(str(path), str(tmp_path / "tree.py"),
                                num_q_heads=32, num_kv_heads=8,
                                head_dim=128)
    raw = json.loads(path.read_text())
    assert raw["decode_tree"] and raw["prefill_tree"] and raw["unified_tree"]
    assert raw["suggested_max_prefill_tokens"] >= 16
    assert set(rep["results"]) == {"decode", "prefill", "unified"}
    theur.load(str(path))
    assert theur.suggested_max_prefill_tokens() \
        == raw["suggested_max_prefill_tokens"]
    assert theur.decode_config(theur.BatchProfile(
        num_seqs=1, max_context=32768, group=4,
        page_size=16)).variant == "segmented"
    # every swept decode scenario dispatches its fitted leaf
    grid = tmb.scenario_grid(seed=2)
    dec = [d for s in grid if (d := tcm.split_phases(s)[0])]
    results = tmb.sweep(dec, tmb.DECODE_SPACE)
    tree = ttune.fit_tree(results, tmb.DECODE_SPACE)
    path.write_text(json.dumps(
        {"decode_tree": ttune.flatten(tree, tmb.DECODE_SPACE)}))
    theur.load(str(path))
    for sc in dec:
        got = theur.decode_config(theur.BatchProfile(
            num_seqs=sc.num_seqs, max_context=sc.max_context,
            group=sc.group, page_size=sc.page_size,
            decode_share=sc.decode_share, avg_query_len=sc.avg_query_len))
        assert got == tmb.DECODE_SPACE[_walk(tree, sc)], sc


def test_hardware_sweep_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _decode(1, 128)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmb.measure(sc, tmb.DECODE_SPACE[0], use_hardware=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmb.measure(sc, tmb.UNIFIED_SPACE[0], use_hardware=True,
                    unified=True)


def test_only_a_launch_limit_is_priced_at_inf(monkeypatch):
    sc = _decode(1, 128)

    def refuse(*a, **k):
        raise LaunchLimitError("needs more shared memory than a block has")

    monkeypatch.setattr(tmb, "_measure_on_device", refuse)
    assert tmb.measure(sc, tmb.DECODE_SPACE[0], use_hardware=True) \
        == math.inf
    monkeypatch.setattr(tmb, "_measure_on_device", lambda *a, **k: 2e-5)
    assert tmb.sweep([sc], tmb.DECODE_SPACE[:2], use_hardware=True,
                     warmup=1, iters=2)[0].timings == {0: 2e-5, 1: 2e-5}

    def malformed(*a, **k):
        raise ValueError("k/v pages must share the tile view")

    monkeypatch.setattr(tmb, "_measure_on_device", malformed)
    with pytest.raises(ValueError, match="tile view"):
        tmb.measure(sc, tmb.DECODE_SPACE[0], use_hardware=True)
