"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro.launch.dryrun`), and its meta route against real ranks.

  * the cell list, `count_params` and `model_flops` of every architecture
    and shape equal the reference's; the reference's figures come from ONE
    subprocess, since importing `repro.launch.dryrun` sets XLA_FLAGS to
    512 host devices, which would leak into this worker;
  * `cache_spec` equals the reference's on a table of (pools, Hkv, head
    dim) x (data, model) meshes, except where the reference splits the
    pages' head_dim: the port keeps those pages whole (`kv_layout`);
  * rank 0 of a fake world of 4 on meta tensors counts exactly what rank
    0 of a real 4-rank gloo world counts on CPU tensors (FLOPs, bytes,
    collective bytes by kind, each kernel's record), on reduced cells of
    each kind across the dense, MoE / MLA, hybrid and ssm families; the
    real ranks' outputs equal one device's (train loss, and each rank's
    block of the serving logits);
  * `--list` prints the reference's 80 cells, and `run_cell` writes a
    record with the reference's keys and a skip with its reason.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_dryrun_ranks as R
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import InputShape
from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_mesh, spawn_ranks
from repro_torch.models import model as M
from repro_torch.training import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_CODE = """
import json
from repro.configs import ARCHS, SHAPES
from repro.launch import dryrun as D
out = {"cells": [list(c) for c in D.all_cells()], "params": {}, "flops": {}}
for arch, cfg in ARCHS.items():
    out["params"][arch] = list(D.count_params(cfg))
    out["flops"][arch] = {s: D.model_flops(cfg, sh) for s, sh in SHAPES.items()}
    out.setdefault("fsdp", sorted(D.FSDP_ARCHS))
    out.setdefault("depths", {})[arch] = [D.roofline_depths(cfg)[0],
        D.roofline_depths(cfg)[1], list(D.roofline_depths(cfg)[2])]
print("JSON" + json.dumps(out))
"""

# name: (arch, config overrides, kind, global batch, seq)
CELLS = {
    "train_hybrid": ("zamba2-1.2b", {}, "train", 4, 32),
    "prefill_mla_moe": ("deepseek-v2-236b", {}, "prefill", 4, 32),
    "decode_ssm": ("xlstm-350m", {}, "decode", 4, 64),
    "decode_ssm_whole": ("xlstm-350m", {"ssm": dict(num_heads=1,
                                                    head_dim=512)},
                         "decode", 4, 64),
    "decode_dense": ("qwen2.5-3b", {}, "decode", 4, 64),
}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_CODE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("JSON")][0]
    return json.loads(line[4:])


def test_cells_params_and_flops_match_reference(reference):
    """The 80 cells in the reference's order; for every architecture the
    (total, active) parameter counts, the FSDP set, the depth pair, and
    MODEL_FLOPS of every shape."""
    assert [list(c) for c in D.all_cells()] == reference["cells"]
    assert len(reference["cells"]) == 80
    assert sorted(SH.FSDP_ARCHS) == reference["fsdp"]
    for arch, cfg in ARCHS.items():
        assert list(D.count_params(cfg)) == reference["params"][arch], arch
        l1, l2, units = D.roofline_depths(cfg)
        assert [l1, l2, list(units)] == reference["depths"][arch], arch
        for s, shape in SHAPES.items():
            assert D.model_flops(cfg, shape) == reference["flops"][arch][s]


def _norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis name (PartitionSpec's
    form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _Mesh:
    """What the reference's cache_spec reads of a mesh: its shape."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh_shape,batch_axes", [
    ({"data": 2, "model": 2}, ("data",)),
    ({"pod": 2, "data": 2, "model": 2}, ("pod", "data")),
])
def test_cache_spec_matches_reference_but_head_dim(mesh_shape, batch_axes):
    """Every (pools, Hkv, D) page leaf and state leaf of a 2 x 2 x 2 table
    gets the reference's spec, except pages whose Hkv does not divide
    'model': the reference splits their head_dim, the port keeps them
    whole (and says so: `kv_layout`)."""
    from repro.distributed import param_sharding as JPS

    mesh = _Mesh(mesh_shape)
    data_n = int(np.prod([mesh_shape[a] for a in batch_axes]))
    differs = 0
    for pools in (1, data_n):
        for hkv in (1, 2, 3):
            for d in (8, 9):
                shape = (2, hkv, pools, 5, 16, d)
                for leaf in ("k_pages", "v_pages"):
                    want = _norm(JPS.cache_spec(
                        f"['attn']['{leaf}']", np.empty(shape),
                        mesh=mesh, batch_axes=batch_axes))
                    got = _norm(PS.cache_spec(f"attn.{leaf}", shape,
                                              mesh_shape=mesh_shape,
                                              batch_axes=batch_axes))
                    if hkv % 2 and d % 2 == 0:  # the head_dim split
                        assert want[-1] == "model" and got[-1] is None
                        assert got[:-1] == want[:-1]
                        assert PS.kv_layout(hkv, 2) == "whole"
                        differs += 1
                    else:
                        assert got == want, (shape, leaf, got, want)
    for shape in ((3, 4, 3, 8), (3, 3, 4), (3, 4, 2, 6, 5), (3, 5)):
        for leaf in ("mamba.ssm", "mamba.conv", "slstm.h", "mlstm.m"):
            want = _norm(JPS.cache_spec(
                "['" + "']['".join(leaf.split(".")) + "']", np.empty(shape),
                mesh=mesh, batch_axes=batch_axes))
            got = _norm(PS.cache_spec(leaf, shape, mesh_shape=mesh_shape,
                                      batch_axes=batch_axes))
            assert got == want, (leaf, shape)
    assert differs == 8


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """Every cell on the real gloo ranks (started meanwhile) and on rank 0
    of a fake world of 4, on meta tensors, in this process."""
    tmp = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(spawn_ranks, R.count_rank, 4, backend="gloo",
                          init_file=str(tmp / "store"), args=(CELLS,))
        fake = {}
        with fake_world(4):
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
            for name, (arch, over, kind, b, s) in CELLS.items():
                cfg = R.cell_cfg(arch, over)
                got = D.count_cell(cfg, InputShape(name, s, b, kind), mesh,
                                   multi_pod=False)
                fake[name] = R.counts(got["count"])
                fake[name]["memory"] = (got["argument_bytes"],
                                        got["peak_bytes"])
        real = fut.result()
    return fake, real


@pytest.mark.parametrize("name", list(CELLS))
def test_fake_world_counts_equal_real_ranks(counted, name):
    """Rank 0 on meta in a fake world and rank 0 on CPU tensors in a gloo
    world: equal FLOPs (aten and kernels), bytes, collective bytes by kind
    and kernel records; something of each was counted (no kernel in
    xlstm's decode)."""
    fake, real = counted
    f, r = fake[name], real[0][name]
    for key in ("flops", "aten_flops", "bytes", "collectives", "kernels"):
        assert f[key] == r[key], (name, key, f[key], r[key])
    assert f["flops"] > 0 and f["bytes"] > 0 and f["collectives"]
    arch, _, kind = CELLS[name][:3]
    # xlstm decodes in PyTorch ops (the reference's decode steps are not
    # Pallas kernels either)
    assert bool(f["kernels"]) == (kind != "decode" or arch != "xlstm-350m")
    assert f["memory"][0] > 0 and f["memory"][1] > 0


def _one_device(name):
    """The cell on one device, CPU, the same weights and batch as the
    ranks: the train loss, or the logits of every row."""
    arch, over, kind, b, s = CELLS[name]
    cfg = R.cell_cfg(arch, over)
    shape = InputShape(name, s, b, kind)
    batch = R.real_batch(cfg, shape, 2)
    if kind == "train":
        model = D._model(cfg, "cpu")
        state = T.make_train_state(model)
        return float(T.train_step(model, state, batch)[1]["loss"])
    pools, pages_per_pool, _ = D._pool_layout(cfg, shape, 2)
    per = b // pools
    apply = M.apply_prefill if kind == "prefill" else M.apply_decode
    model = D._model(cfg, "cpu")
    rows = []
    for p in range(pools):  # one pool a data shard: each pool on its own
        cache = M.make_cache(cfg, max_seqs=per, num_pages=pages_per_pool,
                             device="cpu")
        part = {k: (v[:, p * per:(p + 1) * per] if v.ndim == 3
                    and k == "positions" else v[p * per:(p + 1) * per])
                for k, v in batch.items()}
        rows.append(apply(model, cache, part)[0])
    return torch.cat(rows).numpy()


@pytest.mark.parametrize("name", list(CELLS))
def test_real_ranks_match_one_device(counted, name):
    """Each real rank's output equals one device's: the train loss within
    1e-5 relative; its rows and vocabulary block of the logits within
    1e-4 of their largest magnitude."""
    _, real = counted
    want = _one_device(name)
    for res in real:
        got = res[name]
        if "loss" in got:
            assert abs(got["loss"] - want) <= 1e-5 * abs(want), (got, want)
            continue
        b = CELLS[name][3]
        per = b // 2
        d = got["coord"]["data"]
        lo, hi = got["vocab"]
        ref = want[d * per:(d + 1) * per, lo:hi]
        err = np.abs(got["logits"] - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, got["coord"], err)


def test_list_and_skip_record(tmp_path, capsys):
    """`--list` prints the 80 cells; a long_500k cell of a full-attention
    architecture is recorded as the reference's skip."""
    D.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 80 and lines[0] == "zamba2-1.2b train_4k single"
    rec = D.run_cell("smollm-135m", "long_500k", "multi",
                     out_dir=str(tmp_path))
    assert rec["status"] == "skip"
    assert rec["reason"] == "SKIP(long_500k: pure full-attention arch)"
    assert json.loads((tmp_path / "smollm-135m__long_500k__multi.json")
                      .read_text())["status"] == "skip"
