"""The port's logical-axis rules, parameter specs, `constrain` and GPipe
pipeline (`distributed/{sharding,param_sharding,pipeline}.py`) against
the JAX package.

  * `make_rules` equals `repro.distributed.sharding.make_rules` key for
    key, for every multi_pod / fsdp / sp combination;
  * `param_spec`, for every registry architecture at full size, on the
    production meshes (16, 16) and (2, 16, 16) with fsdp on and off: each
    port parameter's spec equals the reference's `param_spec` of the
    matching leaf (the weight bridge's path, less the stacked [L] entry).
    The port's model is built on the `meta` device and the reference's
    leaves by `jax.eval_shape`, so nothing is allocated; the reference
    reads only `mesh.shape`, so a stand-in carries it;
  * `constrain`: the reference's output sharding under `jit` on a (2, 2)
    host mesh of Auto axes (in a subprocess of 4 forced host devices;
    `jax.make_mesh`'s default Explicit axes refuse it) equals the port's
    layout on a gloo (2, 2) mesh, for divisible shapes, a dimension that
    does not divide, and an axis an earlier dimension took; the port's
    block on each rank is that slice of the whole array, and gathering it
    back gives the whole;
  * `pipeline_apply` at 4 gloo ranks (4 stages) against the reference
    test's sequential tanh(x @ w[i]) (L 8, M 6, mb 2, d 16) computed by
    JAX, 1e-5; `stage_split` against the reference's.
"""
import itertools
import json
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import ARCHS as JARCHS
from repro.distributed import param_sharding as JPS
from repro.distributed import pipeline as JPIPE
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed import pipeline as PIPE
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import production_mesh_shape, spawn_ranks
from repro_torch.models.model import Model
from repro_torch.weights import _leaves

ROOT = Path(__file__).resolve().parents[1]
# (global shape, logical axes) for `constrain`: divisible, a dim that
# does not divide (batch 3, 1 KV head, 3 heads), an axis already taken
SHAPES = [
    ((8, 16, 32), ("batch", "seq_sp", "embed")),
    ((8, 6, 4, 16), ("batch", "seq", "heads", "head_dim")),
    ((3, 16, 32), ("batch", "seq_sp", "embed")),
    ((8, 16, 1, 64), ("batch", "seq", "kv_heads", "head_dim")),
    ((4, 8, 3, 8), ("batch", "seq", "heads", "head_dim")),
    ((8, 4, 6), ("batch", "heads", "ff")),
    ((4, 10, 512), ("batch", "seq", "vocab")),
    ((2, 4, 8, 16), ("batch", "experts", "expert_cap", "embed")),
]
PIPE_L, PIPE_M, PIPE_MB, PIPE_D = 8, 6, 2, 16

# the reference's constrain under jit on a (2, 2) mesh of Auto axes: the
# output sharding's spec of each case, as JSON
REFERENCE_CONSTRAIN = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro.distributed import sharding as sh
shapes = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto, AxisType.Auto))
out = []
with sh.use_rules(mesh, sh.make_rules(sp=True)):
    for shape, axes in shapes:
        f = jax.jit(lambda x, axes=tuple(axes): sh.constrain(x * 2, *axes))
        y = f(jnp.ones(tuple(shape)))
        out.append([None if a is None else
                    ([a] if isinstance(a, str) else list(a))
                    for a in tuple(y.sharding.spec)]
                   + [None] * (len(shape) - len(y.sharding.spec)))
print("SPECS " + json.dumps(out))
"""


def _axes(entry):
    """A spec entry as a tuple of mesh axes, or None."""
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("multi_pod,fsdp,sp", list(
    itertools.product((False, True), repeat=3)))
def test_make_rules_equal_reference(multi_pod, fsdp, sp):
    got = SH.make_rules(multi_pod=multi_pod, fsdp=fsdp, sp=sp)
    want = JSH.make_rules(multi_pod=multi_pod, fsdp=fsdp, sp=sp)
    assert got == want


def _keystr(path) -> str:
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in path)


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_param_spec_equals_reference(arch):
    """Every port parameter's spec equals the reference's for the
    matching leaf, at (16, 16) and (2, 16, 16), fsdp on and off."""
    model = Model(TARCHS[arch], device="meta")
    stacks = PS.reference_stacks(model)
    names = {id(p): n for n, p in model.named_parameters()}
    abstract = jax.eval_shape(lambda k: JM.init(JARCHS[arch], k),
                              jax.random.key(0))
    ref_leaves = {jax.tree_util.keystr(p): leaf for p, leaf in
                  jax.tree_util.tree_flatten_with_path(abstract)[0]}
    seen = set()
    for multi_pod, fsdp in itertools.product((False, True), repeat=2):
        shape, axes = production_mesh_shape(multi_pod)
        mesh_shape = dict(zip(axes, shape))
        batch_axes = ("pod", "data") if multi_pod else ("data",)
        stand_in = types.SimpleNamespace(shape=mesh_shape)
        for path, i, t in _leaves(model):
            name, key = names[id(t)], _keystr(path)
            leaf = ref_leaves[key]
            want = tuple(JPS.param_spec(key, leaf, mesh=stand_in, fsdp=fsdp,
                                        batch_axes=batch_axes))
            want += (None,) * (len(leaf.shape) - len(want))
            if i is not None:  # stacked in the reference: drop its [L]
                assert stacks[name] == leaf.shape[0], name
                want = want[1:]
            got = PS.param_spec(name, t.shape, mesh_shape=mesh_shape,
                                fsdp=fsdp, batch_axes=batch_axes,
                                stacked=stacks[name])
            assert tuple(map(_axes, got)) == tuple(map(_axes, want)), (
                arch, name, multi_pod, fsdp, got, want)
            seen.add(name)
    assert seen == set(names.values())


def test_batch_spec_equals_reference():
    """The batch on its axes where it divides; M-RoPE's [3, B, S]
    positions on dim 1."""
    mesh_shape = {"data": 2, "model": 2}
    stand_in = types.SimpleNamespace(shape=mesh_shape)
    for key, shape in (("inputs", (4, 8)), ("labels", (3, 8)),
                       ("positions", (3, 4, 8)), ("positions", (4, 8)),
                       ("inputs", (4, 8, 16))):
        leaf = types.SimpleNamespace(shape=shape, ndim=len(shape))
        want = tuple(JPS.batch_spec(key, leaf, mesh=stand_in,
                                    batch_axes=("data",)))
        got = PS.batch_spec(key, shape, mesh_shape=mesh_shape,
                            batch_axes=("data",))
        assert tuple(map(_axes, got)) == tuple(map(_axes, want)), key


def _reference_constrain():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_CONSTRAIN,
         json.dumps([[list(s), list(a)] for s, a in SHAPES])],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("SPECS ")]
    return [tuple(None if a is None else tuple(a) for a in spec)
            for spec in json.loads(line[0][len("SPECS "):])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's side in 4 gloo ranks while the reference's constrain
    runs in a subprocess and its pipeline here."""
    key = jax.random.key(0)
    w = np.asarray(jax.random.normal(key, (PIPE_L, PIPE_D, PIPE_D)) * 0.3)
    x = np.asarray(jax.random.normal(jax.random.key(1),
                                     (PIPE_M, PIPE_MB, PIPE_D)))
    tmp = tmp_path_factory.mktemp("rules")
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(spawn_ranks, R.rules_rank, 4, backend="gloo",
                          init_file=str(tmp / "store"),
                          args=(SHAPES, {"w": w, "x": x}))
        specs = _reference_constrain()
        ref = x
        for i in range(PIPE_L):
            ref = np.asarray(jax.numpy.tanh(ref @ w[i]))
        res = fut.result()
    return dict(res=res, specs=specs, pipe_ref=ref, w=w)


def test_constrain_equals_reference(ranks):
    """Each case's layout equals the reference's output sharding, on
    every rank, and each rank's block is its slice of the whole."""
    for r, res in enumerate(ranks["res"]):
        assert res["layouts"] == ranks["specs"], r
        assert all(res["blocks_ok"]), (r, res["blocks_ok"])
        assert res["placements"] == [("Shard", 0), ("Shard", 1)]
    # the fallbacks were exercised
    assert ranks["specs"][2][0] is None and ranks["specs"][3][2] is None
    assert ranks["specs"][5] == (("data",), ("model",), None)


def test_pipeline_matches_sequential(ranks):
    """Every rank's pipeline output equals the sequential product."""
    for res in ranks["res"]:
        np.testing.assert_allclose(res["pipeline"], ranks["pipe_ref"],
                                   atol=1e-5)


def test_stage_split_equals_reference(ranks):
    w = ranks["w"]
    want = np.asarray(JPIPE.stage_split({"w": w}, 4)["w"])
    got = PIPE.stage_split({"w": torch.from_numpy(w.copy())}, 4)["w"].numpy()
    assert got.shape == (4, PIPE_L // 4, PIPE_D, PIPE_D)
    np.testing.assert_array_equal(got, want)
