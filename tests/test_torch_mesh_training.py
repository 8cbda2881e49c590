"""The port's train step on a (data 2, model 2) mesh against the reference's
one-device `make_train_step`.

GSPMD changes where numbers live, not what is computed, so the
reference's step on one device (no mesh: its `constrain` calls are
no-ops) is the oracle for the port's mesh step.  Four gloo ranks on the
CPU (started once for the module by `spawn_ranks`; each imports only
torch and repro_torch, tests/torch_mesh_ranks.py) run every case while
this process runs the reference; data crosses as numpy.  Weights come
from `M.init(cfg, jax.random.key(0))` through the bridge, fp32.

  (a) reduced qwen2.5-3b (4 / 1 heads: the column split of `wk`, one
      64-wide head over 2 ranks, cuts the head; the attention reads it
      whole) with FSDP and sequence parallelism, two steps: loss, ce and
      grad norm within 1e-5 relative; every gradient leaf within 1e-5 of
      its largest element; the parameters after the update (below);
  (b) the same with 2 KV heads (whole heads a rank), reduced
      qwen2-vl-2b (embedding inputs, M-RoPE [3, B, S] positions split on
      dim 1), and qwen with 2 microbatches against the reference's
      `make_train_step(microbatches=2)`: loss, ce, grad norm;
  (c) reduced deepseek-v2 (MLA, a lead dense block, MoE) at B 2 x S 16
      with capacity factor 0.5 (pairs dropped), the dispatch einsum in
      fp32 on both sides as in tests/test_torch_train_moe.py: one group
      (it does not divide over the 2 data ranks: every rank routes it) and
      groups of 16 (one a data rank): loss, aux, grad norm within 1e-5,
      the kept (token, choice) pairs those of the reference;
  (d) the fused `wqkv` / `gate_up` layouts on the mesh against the port's
      own one-device step, 1e-5 (metrics, gradient leaves, the update);
  (e) every split leaf holds numel / (its mesh axes' size) elements on
      each rank, and the moments are placed as their parameters;
  (f) the whole state saved at (2, 2) after two steps restores on one
      device: its third step's loss equals the mesh's within 1e-6;
  (g) a wrong world size and the production mesh on 4 ranks are
      refused; `launch.train --mesh 2x2` runs in the ranks and matches
      `--mesh 1x1`;
  (h) reduced zamba2 and xlstm (the hybrid and ssm families, a head of
      each recurrent block a model rank) with FSDP and sequence
      parallelism, two steps: loss, ce and grad norm within 1e-5
      relative, every gradient leaf within 1e-5 of its largest element
      against the port's one-device step and against the reference's
      (xlstm: 1e-4, `REF_GRAD_TOL`), the update as in (a).

Parameters after two steps are held in two parts.  AdamW divides each
gradient element by its own running magnitude, so a gradient that agrees
to ~1e-6 of its leaf's largest (the ranks sum in other orders) moves a
small element's update by far more: the first step's learning rate is 0,
and where the second step's 0.09 g1 + 0.1 g2 nearly cancels, or g is
~1e-3 of its leaf's largest, two correct implementations land apart by
up to lr.  So (a) holds every gradient leaf of both steps (complete sums,
before the clip, recorded whole on the ranks) within 1e-5 of the leaf's
largest against `jax.grad` of the reference's loss, the grad norm at
1e-5, and every parameter after the last step within 1e-5 of its
leaf's largest against one-device AdamW applied to the mesh's own
recorded inputs (gradients, moments, count, lr): the sharded update,
element by element.  (d) does the same against the port's one-device
step.
"""
import contextlib
import io
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.training.trainer import make_train_step
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as TO
from repro_torch.training import trainer as T
from repro_torch.training.data import DataState, MarkovDataset
from repro_torch.training.trainer import (
    load_state_tensors, make_train_state, train_step,
)

STEP_KW = dict(base_lr=1e-2, warmup=5, total_steps=60)
QWEN, VL, DSV2 = "qwen2.5-3b", "qwen2-vl-2b", "deepseek-v2-236b"
ZAMBA, XLSTM = "zamba2-1.2b", "xlstm-350m"
CASES = {  # name: (arch, overrides, batch, seq, steps)
    "qwen": (QWEN, {}, 4, 32, 3),
    "qwen_kv2": (QWEN, {"num_kv_heads": 2}, 4, 32, 2),
    "vl": (VL, {}, 4, 32, 2),
    "dsv2": (DSV2, {}, 2, 16, 2),
    "dsv2_g16": (DSV2, {}, 2, 16, 2),
    "fused": (QWEN, {"fused_qkv": True, "fused_mlp": True}, 4, 32, 2),
    "qwen_mb2": (QWEN, {}, 4, 32, 2),
    "zamba2": (ZAMBA, {}, 4, 32, 2),
    "xlstm": (XLSTM, {}, 4, 32, 2),
}
RECURRENT = ("zamba2", "xlstm")
MICROBATCHES = {"qwen_mb2": 2}  # else 1
DSV2_MOE = dict(capacity_factor=0.5)  # capacity 8 of 32 pairs an expert
LAUNCH = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
          "--steps", "2", "--global-batch", "4", "--seq", "32"]


def _cfgs(arch, overrides):
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32", **overrides)
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32", **overrides)
    if arch == DSV2:
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(
            **{**jcfg.moe.__dict__, **DSV2_MOE}))
        tcfg = tcfg.replace(moe=tcfg.moe.__class__(
            **{**tcfg.moe.__dict__, **DSV2_MOE}))
    return jcfg, tcfg


def _batches(cfg, n, b, s, seed=3):
    ds = MarkovDataset(cfg.vocab_size, seed=1)
    dstate, out = DataState(seed=1), []
    rng = np.random.default_rng(seed)
    for _ in range(n):
        batch, dstate = ds.batch(dstate, batch_size=b, seq_len=s)
        batch = {k: np.array(v) for k, v in batch.items()}
        if cfg.input_kind == "embeds":
            batch["inputs"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
        if cfg.rope_style == "mrope":  # a patch grid after two text tokens
            j = np.arange(s - 2)
            pos = np.zeros((3, b, s), np.int32)
            pos[:, :, :2] = np.arange(2)
            pos[0, :, 2:] = 2
            pos[1, :, 2:] = 2 + j // 6
            pos[2, :, 2:] = 2 + j % 6
            batch["positions"] = pos
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def setup():
    """The reference's weights and batches of every case."""
    out, inits = {}, {}
    for name, (arch, over, b, s, steps) in CASES.items():
        jcfg, tcfg = _cfgs(arch, over)
        key = (arch, tuple(sorted(over.items())))
        if key not in inits:
            params = JM.init(jcfg, jax.random.key(0))
            inits[key] = (params, jax.tree.map(np.asarray, params))
        params, params_np = inits[key]
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, params=params,
                         params_np=params_np,
                         batches=_batches(tcfg, steps, b, s))
    return out


def _step_kw(name):
    return dict(STEP_KW, microbatches=MICROBATCHES.get(name, 1))


def _rank_cases(setup, ckpt):
    cases = {}
    for name, c in setup.items():
        arch, over = CASES[name][:2]
        cases[name] = dict(
            arch=arch, overrides=over, params=c["params_np"],
            batches=c["batches"], fsdp=True, step_kw=_step_kw(name),
            record=name in ("qwen", "fused") + RECURRENT,
            layout=name == "qwen",
            fp32_dispatch=arch == DSV2, count_drops=arch == DSV2)
        if arch == DSV2:
            cases[name]["overrides"] = {**over, "moe": c["tcfg"].moe}
    cases["dsv2_g16"]["group_size"] = 16
    cases["qwen"].update(ckpt=ckpt, ckpt_after=2)
    return cases


class _Fp32Dispatch:
    """`jax.numpy` as `repro.models.moe` sees it, with bfloat16 read as
    float32 (tests/test_torch_train_moe.py)."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _reference(c, steps, microbatches=1):
    """The reference's metrics of `steps` steps and its state after two."""
    from repro.training.optimizer import adamw_init

    step = make_train_step(c["jcfg"], donate=False,
                           microbatches=microbatches, **STEP_KW)
    state = {"params": c["params"], "opt": adamw_init(c["params"]),
             "step": jnp.zeros((), jnp.int32)}
    metrics, after_two = [], None
    for i in range(steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in c["batches"][i].items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 1:
            after_two = state
    return metrics, after_two


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every case in the ranks while this process computes the
    references; the one-device references of (d), (f) and (g)."""
    tmp = tmp_path_factory.mktemp("mesh")
    ckpt = str(tmp / "ckpt")
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(spawn_ranks, R.mesh_train_rank, 4,
                          backend="gloo", init_file=str(tmp / "store"),
                          args=(_rank_cases(setup, ckpt),
                                LAUNCH + ["--mesh", "2x2"]))
        refs = {}
        with pytest.MonkeyPatch.context() as mp:
            for name in ("qwen", "qwen_kv2", "vl", "qwen_mb2") + RECURRENT:
                refs[name] = _reference(setup[name], 2,
                                        MICROBATCHES.get(name, 1))
            mp.setattr(JMOE, "jnp", _Fp32Dispatch())
            refs["dsv2"] = _reference(setup["dsv2"], 2)
            mp.setattr(JMOE, "MOE_GROUP_SIZE", 16)
            refs["dsv2_g16"] = _reference(setup["dsv2_g16"], 2)
        res = fut.result()
    return dict(res=res, refs=refs, ckpt=ckpt)


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


@pytest.mark.parametrize("name", ["qwen", "qwen_kv2", "vl", "dsv2",
                                  "dsv2_g16", "qwen_mb2", "zamba2", "xlstm"])
def test_mesh_step_matches_reference(ranks, name):
    """(a)-(c): every rank's loss, ce, aux and grad norm of both steps
    within 1e-5 relative of the reference's one-device step (identical on
    every rank); `qwen_mb2` accumulates over 2 microbatches of 2 rows
    (one a data rank) against the reference's scan over 2."""
    want, _ = ranks["refs"][name]
    # the reference's scan over microbatches reports no ce
    keys = ("loss", "grad_norm") if name in MICROBATCHES else \
        ("loss", "ce", "grad_norm")
    for r, res in enumerate(ranks["res"]):
        for i, (got, ref) in enumerate(zip(res[name]["metrics"], want)):
            for key in keys:
                _close(got[key], ref[key], 1e-5, (name, r, i, key))
            if name.startswith("dsv2"):
                assert ref["aux"] > 0
                _close(got["aux"], ref["aux"], 1e-5, (name, r, i, "aux"))
        assert res[name]["metrics"] == ranks["res"][0][name]["metrics"]


def _reference_kept(setup, name, group_size):
    """The kept (token, choice) pairs of the reference's first MoE
    forward on the initial weights, per MoE layer: the sum of its
    dispatch one-hot (read by a callback at its `constrain` site; the
    combine weights, at the same site, are not all 0 / 1), dispatch in
    fp32 as on the ranks."""
    c = setup[name]
    got = []

    def record(v):
        v = np.asarray(v, np.float32)
        if np.isin(v, (0.0, 1.0)).all():
            got.append(int(v.sum()))

    def spy(x, *axes):
        if axes == ("batch", None, "experts", "expert_cap"):
            jax.debug.callback(record, x)
        return x
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMOE, "constrain", spy)
        mp.setattr(JMOE, "jnp", _Fp32Dispatch())
        mp.setattr(JMOE, "MOE_GROUP_SIZE", group_size)
        jax.block_until_ready(jax.jit(lambda p, b: JM.apply_train(
            c["jcfg"], p, b))(c["params"], {
                k: jnp.asarray(v) for k, v in c["batches"][0].items()}))
    jax.effects_barrier()
    return got


@pytest.mark.parametrize("name,group_size", [("dsv2", 4096),
                                             ("dsv2_g16", 16)])
def test_mesh_moe_drops_match_reference(setup, ranks, name, group_size):
    """(c): the kept pairs of the first forward, layer by layer, summed
    over the data ranks where the groups split over them (one group: every
    rank routes all of it), equal the reference's; some are dropped."""
    want = _reference_kept(setup, name, group_size)
    res = ranks["res"]
    b, s = CASES[name][2:4]
    k = setup[name]["tcfg"].moe.top_k
    for r, out in enumerate(res):
        kept = out[name]["kept"]
        assert len(kept) == len(want)
        for layer, (n_kept, n_routed) in enumerate(kept):
            if n_routed == b * s * k:  # every group on every rank
                assert n_kept == want[layer], (name, r, layer)
            else:  # this data rank's groups: add the other data rank's
                other = res[(r + 2) % 4][name]["kept"][layer]
                assert n_kept + other[0] == want[layer], (name, r, layer)
    assert min(want) < b * s * k


def _one_device_update(rec, names):
    """The port's one-device AdamW on a recorded update's inputs: the new
    parameters by name, and the global norm it computes."""
    def ts(key):
        return [torch.from_numpy(rec[key][n]) for n in names]
    params = ts("params")
    opt = {"mu": ts("mu"), "nu": ts("nu"),
           "count": torch.tensor(rec["count"], dtype=torch.int32)}
    _, _, m = TO.adamw_update(ts("grads"), opt, params, lr=rec["lr"])
    return dict(zip(names, (p.numpy() for p in params))), float(m["grad_norm"])


def _check_update(res, names):
    """The mesh's parameters after its last step equal one-device AdamW on
    the inputs the mesh recorded for it (1e-5 of each leaf's largest), and
    its global norm that of the whole gradients (1e-6)."""
    want, gnorm = _one_device_update(res["updates"][-1], names)
    _close(res["updates"][-1]["gnorm"], gnorm, 1e-6, "global norm")
    for name in names:
        err = np.abs(res["params"][name] - want[name]).max()
        assert err <= 1e-5 * np.abs(want[name]).max(), (name, err)


def test_mesh_grads_and_update_match_reference(setup, ranks):
    """(a): every gradient leaf of the first two steps within 1e-5 of its
    largest element against `jax.grad` of the reference's loss (the first
    step leaves the weights where they were: lr 0), and the parameters
    after the last step (the third, taken for (f)) against one-device
    AdamW on the mesh's recorded inputs (module docstring)."""
    c = setup["qwen"]
    res = ranks["res"][0]["qwen"]
    names = list(res["params"])
    grad = jax.jit(jax.grad(lambda p, b: JM.apply_train(c["jcfg"], p, b)[0]))
    for i, rec in enumerate(res["updates"][:2]):
        want = grad(c["params"], {k: jnp.asarray(v)
                                  for k, v in c["batches"][i].items()})
        got = _tree(c["tcfg"], c["params_np"], rec["grads"])
        for path, g in jax.tree_util.tree_leaves_with_path(got):
            ref = np.asarray(_at(want, path))
            err = np.abs(g - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (
                i, jax.tree_util.keystr(path), err)
    _check_update(res, names)


# gradient leaves against the reference's: zamba2 at 1e-5 of each leaf's
# largest; xlstm at the one-device bound of test_torch_train_recurrent
# (1e-4): on this batch the port's one-device gradient of the mLSTM gate
# bias is itself 1.02e-5 of its largest from the reference's (the chunked
# mLSTM's fp32 sums in another order), so the mesh's own error is held
# against the port's one-device step instead, at 1e-5
REF_GRAD_TOL = {"zamba2": 1e-5, "xlstm": 1e-4}


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_mesh_grads_match_reference(setup, ranks, name):
    """(h): the hybrid (zamba2: the Mamba2 blocks on a head each of the
    two model ranks, in_proj's packed output taken by columns, the shared
    attention block) and ssm (xlstm: the mLSTM and sLSTM blocks on a head
    each) families: every gradient leaf of both steps within 1e-5 of its
    largest element against the port's one-device step on the same
    weights and batches, and against `jax.grad` of the reference's loss
    within `REF_GRAD_TOL`; the parameters after the last step against
    one-device AdamW on the mesh's recorded inputs."""
    c = setup[name]
    res = ranks["res"][0][name]
    names = list(res["params"])
    model = weights.from_jax_params(c["tcfg"], c["params_np"], device="cpu")
    state = make_train_state(model)
    local = []
    with R.patched(T, "adamw_update", _local_recorder(names, local)):
        for batch in c["batches"]:
            state, _ = train_step(model, state, R.to_torch(batch),
                                  **STEP_KW)
    grad = jax.jit(jax.grad(lambda p, b: JM.apply_train(c["jcfg"], p, b)[0]))
    for i, rec in enumerate(res["updates"]):
        for n in names:
            ref = local[i]["grads"][n]
            err = np.abs(rec["grads"][n] - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (name, i, n, err)
        want = grad(c["params"], {k: jnp.asarray(v)
                                  for k, v in c["batches"][i].items()})
        got = _tree(c["tcfg"], c["params_np"], rec["grads"])
        for path, g in jax.tree_util.tree_leaves_with_path(got):
            ref = np.asarray(_at(want, path))
            err = np.abs(g - ref).max()
            assert err <= REF_GRAD_TOL[name] * np.abs(ref).max(), (
                name, i, jax.tree_util.keystr(path), err)
    _check_update(res, names)


def _tree(tcfg, params_np, named):
    """The reference-layout numpy tree of port parameters `named`."""
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(named[name]))
    return weights.to_numpy_params(model)


def _at(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", getattr(key, "idx", None))]
    return tree


def test_fused_layouts_on_mesh_match_one_device(setup, ranks):
    """(d): the fused `wqkv` / `gate_up` model on the mesh against the
    port's one-device step: metrics 1e-5; every gradient leaf of both
    steps within 1e-5 of its largest; the parameters after two steps
    against one-device AdamW on the mesh's recorded inputs."""
    c = setup["fused"]
    model = weights.from_jax_params(c["tcfg"], c["params_np"], device="cpu")
    state = make_train_state(model)
    names = [n for n, _ in model.named_parameters()]
    res = ranks["res"][0]["fused"]
    records = []
    with R.patched(T, "adamw_update", _local_recorder(names, records)):
        for i, batch in enumerate(c["batches"]):
            state, m = train_step(model, state, R.to_torch(batch),
                                  **STEP_KW)
            for r, out in enumerate(ranks["res"]):
                got = out["fused"]["metrics"][i]
                for key in ("loss", "ce", "grad_norm"):
                    _close(got[key], float(m[key]), 1e-5, (r, i, key))
    for i, rec in enumerate(records):
        for name in names:
            ref = rec["grads"][name]
            err = np.abs(res["updates"][i]["grads"][name] - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (i, name, err)
    _check_update(res, names)


def _local_recorder(names, records):
    """`adamw_update` recording its inputs on one device (no mesh)."""
    inner = T.adamw_update

    def recording(grads, opt_state, params, **kw):
        records.append(dict(grads={n: g.detach().numpy().copy()
                                   for n, g in zip(names, grads)}))
        return inner(grads, opt_state, params, **kw)
    return recording


def test_every_rank_holds_its_block(ranks):
    """(e): a leaf split over mesh axes of n ranks holds numel / n
    elements on each rank; the moments carry the parameter's layout and
    size; under FSDP the matrices are split over both axes."""
    layout = ranks["res"][0]["qwen"]["layout"]
    n_axes = {("data",): 2, ("model",): 2}
    both = 0
    for name, (local, whole, spec, mu, nu, mu_n) in layout.items():
        n = 1
        for axes in (spec or ()):
            if axes:
                n *= int(np.prod([n_axes[(a,)] for a in axes]))
        assert local * n == whole, (name, local, whole, spec)
        assert mu == nu == spec and mu_n == local, name
        both += n == 4
    assert layout["blocks.0.attn.wk.w"][2] == (("data",), ("model",))
    assert layout["embed"][2] == (("model",), ("data",))
    assert both >= 4 * 6
    for res in ranks["res"][1:]:
        assert {k: v[0] for k, v in res["qwen"]["layout"].items()} == \
            {k: v[0] for k, v in layout.items()}


def test_checkpoint_restores_on_one_device(setup, ranks):
    """(f): the whole state the mesh saved after two steps restores into
    a one-device model; its third step's loss equals the mesh's."""
    c = setup["qwen"]
    tensors, step, _ = C.restore(ranks["ckpt"])
    assert step == 2
    model = Model(c["tcfg"], device="cpu")
    state = load_state_tensors(model, tensors)
    state, m = train_step(model, state, R.to_torch(c["batches"][2]),
                          **STEP_KW)
    want = ranks["res"][0]["qwen"]["metrics"][2]["loss"]
    _close(float(m["loss"]), want, 1e-6, "loss after restore")
    assert int(state["step"]) == 3


def test_refusals(ranks):
    """(g): the wrong world and the production mesh on 4 ranks name what
    they need (the hybrid and ssm families now train on the mesh: (h))."""
    for res in ranks["res"]:
        ref = res["refusals"]
        assert "needs 8 ranks; the world has 4" in ref["world"]
        assert "(16, 16)" in ref["production"] and "256" in ref["production"]
        assert set(ref) == {"world", "production"}


@pytest.fixture(scope="module")
def one_device_launch():
    """`launch.train` at `--mesh 1x1` (its default) in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(LAUNCH)
    return buf.getvalue()


def test_launcher_mesh_against_one_device(ranks, one_device_launch):
    """(g): `launch.train --mesh 2x2` (main() in each rank) against
    `--mesh 1x1` in this process: the same losses within 1e-5; rank 0
    alone prints the step lines, every rank its share of the
    parameters."""
    def losses(text):
        return [float(line.split()[3]) for line in text.splitlines()
                if line.startswith("step ")]
    outs = [res["launcher"] for res in ranks["res"]]
    want = losses(one_device_launch)
    assert len(want) == 2
    got = losses(outs[0])
    assert len(got) == 2 and all(not losses(o) for o in outs[1:])
    for g, w in zip(got, want):
        _close(g, w, 1e-5, "launcher loss")
    for r, out in enumerate(outs):
        assert f"rank {r} " in out and "parameters held" in out
