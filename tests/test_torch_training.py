"""The port's training path against the JAX reference on the reduced
smollm-135m with 2 layers in fp32 (the model of tests/test_training.py),
weights carried over with `from_jax_params`, data from the same
`MarkovDataset` stream.

Held separately, because a cross-framework AdamW step is brittle (on
step 1 the update is about lr * g / (|g| + eps), so an element with a
tiny gradient can flip sign over a 1e-7 difference):

  * `apply_train`: the loss at atol 1e-5, every gradient leaf at 1e-4;
  * `adamw_update` and `cosine_schedule` on identical inputs at 1e-6;
  * the losses of 3 `train_step`s against `make_train_step` at 1e-4.

Plus the port's own contracts: microbatch accumulation (1 / 2 / 4) at
1e-6, bit-exact checkpoint restart, checkpoint GC and atomicity, and the
launcher on the CPU.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training.trainer import make_train_step
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as TO
from repro_torch.training.data import DataState, MarkovDataset
from repro_torch.training.trainer import (
    load_state_tensors, make_train_state, state_tensors, train_step,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
STEP_KW = dict(base_lr=1e-2, warmup=5, total_steps=60)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(JARCHS["smollm-135m"]).replace(num_layers=2)
    tcfg = treduced(TARCHS["smollm-135m"]).replace(num_layers=2)
    assert tcfg.dtype == "float32"
    params = JM.init(jcfg, jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _model(tcfg, params_np):
    return weights.from_jax_params(tcfg, params_np, device="cpu")


def _batches(cfg, n, batch_size=8, seq_len=64):
    ds = MarkovDataset(cfg.vocab_size, seed=1)
    dstate, out = DataState(seed=1), []
    for _ in range(n):
        b, dstate = ds.batch(dstate, batch_size=batch_size, seq_len=seq_len)
        out.append(b)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_apply_train_loss_and_grads_match_reference(setup):
    jcfg, tcfg, params, params_np = setup
    batch = _batches(tcfg, 1, batch_size=4)[0]
    batch["labels"] = batch["labels"].copy()  # a view into the inputs
    batch["labels"][0, :5] = -1  # ignored positions
    (want, jm), jgrads = jax.value_and_grad(
        lambda p: JM.apply_train(jcfg, p, {k: jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True)(params)
    model = _model(tcfg, params_np).requires_grad_(True)
    loss, m = TM.apply_train(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    assert int(m["tokens"]) == int(jm["tokens"]) == 4 * 64 - 5
    assert float(m["aux"]) == 0.0
    got = jax.tree_util.tree_leaves_with_path(
        weights.to_numpy_params(model, grads=True))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got) == len(ref)
    for path, g in got:
        np.testing.assert_allclose(g, np.asarray(ref[path]), atol=1e-4,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_to_numpy_params_round_trips(setup):
    _, tcfg, _, params_np = setup
    back = weights.to_numpy_params(_model(tcfg, params_np))
    jax.tree.map(np.testing.assert_array_equal, back, params_np)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One AdamW step at count 3 with clipping active, on identical
    inputs.  fp32 at 1e-6; bf16 parameters are updated in fp32 and cast
    back, so there the results may differ by one bf16 rounding (2^-8
    relative) where the fp32 values straddle a rounding boundary."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (3,), (4, 2, 3)]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = [rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
    mu = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    nu = [np.abs(rng.standard_normal(s)).astype(np.float32) * 0.1
          for s in shapes]
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp, jo, jm = JO.adamw_update(
        [jnp.asarray(x, jd) for x in g],
        {"mu": [jnp.asarray(x) for x in mu], "nu": [jnp.asarray(x) for x in nu],
         "count": jnp.asarray(3, jnp.int32)},
        [jnp.asarray(x, jd) for x in p], **kw)
    tp, to, tm = TO.adamw_update(
        [torch.from_numpy(x).to(td) for x in g],
        {"mu": [torch.from_numpy(x) for x in mu],
         "nu": [torch.from_numpy(x) for x in nu],
         "count": torch.tensor(3, dtype=torch.int32)},
        [torch.from_numpy(x).to(td) for x in p], **kw)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    for a, b in zip(tp, jp):
        assert a.dtype == td
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=1e-6, rtol=tol)
    for name in ("mu", "nu"):
        for a, b in zip(to[name], jo[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    assert int(to["count"]) == int(jo["count"]) == 4
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 7, 20, 55, 100, 130])
def test_cosine_schedule_matches_reference(step):
    kw = dict(base_lr=3e-4, warmup=20, total=100)
    want = JO.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
    got = TO.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), atol=1e-9, rtol=1e-6)


def test_train_steps_match_reference(setup):
    jcfg, tcfg, params, params_np = setup
    batches = _batches(tcfg, 3)
    jstep = make_train_step(jcfg, **STEP_KW, donate=False)
    jstate = {"params": params, "opt": JO.adamw_init(params),
              "step": jnp.zeros((), jnp.int32)}
    model = _model(tcfg, params_np)
    state = make_train_state(model)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = train_step(model, state, _torch(b), **STEP_KW)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3


def test_microbatch_accumulation(setup):
    _, tcfg, _, params_np = setup
    batch = _torch(_batches(tcfg, 1)[0])
    outs, losses = [], []
    for mb in (1, 2, 4):
        model = _model(tcfg, params_np)
        _, m = train_step(model, make_train_state(model), batch,
                          microbatches=mb, **STEP_KW)
        outs.append(weights.to_numpy_params(model))
        losses.append(float(m["loss"]))
    for other in outs[1:]:
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, atol=1e-6, rtol=1e-6), outs[0], other)
    np.testing.assert_allclose(losses[1:], [losses[0]] * 2, rtol=1e-6)


def _train(tcfg, params_np, batches, model=None, state=None):
    model = model or _model(tcfg, params_np)
    state = state or make_train_state(model)
    for b in batches:
        state, _ = train_step(model, state, _torch(b), **STEP_KW)
    return model, state


def test_checkpoint_restart_is_bit_exact(setup, tmp_path):
    """Train 4 steps; vs train 2, save, restore into a fresh model, train
    2 more: the same parameters, moments and step, bit for bit."""
    _, tcfg, _, params_np = setup
    batches = _batches(tcfg, 4)
    model_a, state_a = _train(tcfg, params_np, batches)
    model_b, state_b = _train(tcfg, params_np, batches[:2])
    C.save(str(tmp_path), state_tensors(model_b, state_b), step=2,
           data_state=DataState(seed=1, step=2))
    tensors, step, dstate = C.restore(str(tmp_path))
    assert step == 2 and dstate == DataState(seed=1, step=2)
    fresh = weights.init_random(tcfg, 5, device="cpu")
    state_c = load_state_tensors(fresh, tensors)
    model_c, state_c = _train(tcfg, params_np, batches[2:], fresh, state_c)
    a, c = state_tensors(model_a, state_a), state_tensors(model_c, state_c)
    assert a.keys() == c.keys()
    for key in a:
        torch.testing.assert_close(a[key], c[key], atol=0, rtol=0, msg=key)


def test_async_checkpointer_and_gc(setup, tmp_path):
    _, tcfg, _, params_np = setup
    model = _model(tcfg, params_np)
    tensors = state_tensors(model, make_train_state(model))
    ck = C.AsyncCheckpointer()
    for s in (10, 20, 30, 40):
        ck.save_async(str(tmp_path), tensors, step=s,
                      data_state=DataState(1, s), keep_last_n=2)
    ck.wait()
    kept = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert kept == ["step_00000030", "step_00000040"]
    assert C.latest_step(str(tmp_path)) == 40
    assert C.restore(str(tmp_path))[2] == DataState(1, 40)


def test_checkpoint_atomicity_on_partial_write(setup, tmp_path):
    """A leftover .tmp dir (a crash mid-write) must not shadow a valid
    checkpoint."""
    _, tcfg, _, params_np = setup
    model = _model(tcfg, params_np)
    C.save(str(tmp_path), state_tensors(model, make_train_state(model)),
           step=5)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert C.latest_step(str(tmp_path)) == 5
    _, step, _ = C.restore(str(tmp_path))
    assert step == 5


def test_train_launcher_runs_on_cpu(tmp_path):
    """Three steps on the CPU with a checkpoint at step 2, then a second
    run that resumes there; the plain attention runs, no kernel."""
    env = {**os.environ, "PYTHONPATH": SRC}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-135m", "--reduced", "--device", "cpu", "--global-batch",
           "4", "--seq", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every",
           "2"]
    out = subprocess.run(cmd + ["--steps", "2"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step 1 loss" in out.stdout and "on the CPU" in out.stdout
    out = subprocess.run(cmd + ["--steps", "3"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "resumed at step 2" in out.stdout
    assert "step 2 loss" in out.stdout and "step 1 loss" not in out.stdout
    assert "flash kernel launches 0" in out.stdout
