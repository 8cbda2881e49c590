"""Training of the recurrent families against the JAX reference on the
CPU, fp32: reduced zamba2-1.2b (hybrid: 2 Mamba2 blocks, the shared
attention block used twice) and reduced xlstm-350m (ssm: 2 mLSTM and 2
sLSTM blocks), weights carried across by `weights.from_jax_params`, data
from `MarkovDataset` (2 x 64: two scan chunks of 32):

  * `apply_train`: the loss and ce within 1e-5 relative, every gradient
    leaf (`to_numpy_params(grads=True)`) against `jax.grad(M.apply_train)`
    at atol / rtol 1e-4 (the shared block's one gradient summed over its
    uses);
  * 3 `train_step`s against `make_train_step` (losses at 1e-4, as the
    dense test);
  * microbatches 2 against one batch (parameters at 1e-6, as the dense
    test);
  * the weight bridge round trip on a trained model, whose tree gives the
    port's loss in the reference (1e-5), and a bit-exact checkpoint
    restart;
  * `launch.train`'s `main` with `--arch {zamba2-1.2b,xlstm-350m} --reduced
    --device cpu`.

One jitted `jax.value_and_grad(M.apply_train)` a family serves the
gradient and the bridge tests.
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
from repro_torch.training.data import DataState, MarkovDataset
from repro_torch.training.trainer import (
    load_state_tensors, make_train_state, state_tensors, train_step,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCHS = ("zamba2-1.2b", "xlstm-350m")
STEP_KW = dict(base_lr=1e-2, warmup=5, total_steps=60)
LEAF_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(jcfg, tcfg, params, params_np, the jitted value_and_grad of the
    reference's apply_train over (params, batch))."""
    arch = request.param
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    params = jax.jit(lambda key: JM.init(jcfg, key))(jax.random.key(0))
    vag = jax.jit(jax.value_and_grad(
        lambda p, b: JM.apply_train(jcfg, p, b), has_aux=True))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params), vag


def _batches(cfg, n, batch_size=2, seq_len=64):
    ds = MarkovDataset(cfg.vocab_size, seed=1)
    dstate, out = DataState(seed=1), []
    for _ in range(n):
        b, dstate = ds.batch(dstate, batch_size=batch_size, seq_len=seq_len)
        out.append(b)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _model(tcfg, params_np):
    return weights.from_jax_params(tcfg, params_np, device="cpu")


def test_apply_train_matches_reference(family):
    jcfg, tcfg, params, params_np, vag = family
    batch = _batches(tcfg, 1)[0]
    batch["labels"] = batch["labels"].copy()  # a view into the inputs
    batch["labels"][0, :5] = -1  # ignored positions
    (want, jm), jgrads = vag(params, _jax(batch))
    model = _model(tcfg, params_np).requires_grad_(True)
    loss, m = TM.apply_train(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"].detach()), float(jm["ce"]),
                               rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert int(m["tokens"]) == int(jm["tokens"]) == 2 * 64 - 5
    got = jax.tree_util.tree_leaves_with_path(
        weights.to_numpy_params(model, grads=True))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got) == len(ref)
    for path, g in got:
        np.testing.assert_allclose(g, np.asarray(ref[path]),
                                   err_msg=jax.tree_util.keystr(path),
                                   **LEAF_TOL)


def test_train_steps_match_reference(family):
    jcfg, tcfg, params, params_np, _ = family
    jstep = make_train_step(jcfg, **STEP_KW, donate=False)
    jstate = {"params": params, "opt": JO.adamw_init(params),
              "step": jnp.zeros((), jnp.int32)}
    model = _model(tcfg, params_np)
    state = make_train_state(model)
    for b in _batches(tcfg, 3):
        jstate, jm = jstep(jstate, _jax(b))
        state, m = train_step(model, state, _torch(b), **STEP_KW)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3


def test_microbatches_equal_one_batch(family):
    _, tcfg, _, params_np, _ = family
    batch = _torch(_batches(tcfg, 1, batch_size=4)[0])
    outs, losses = [], []
    for mb in (1, 2):
        model = _model(tcfg, params_np)
        _, m = train_step(model, make_train_state(model), batch,
                          microbatches=mb, **STEP_KW)
        outs.append(weights.to_numpy_params(model))
        losses.append(float(m["loss"]))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, atol=1e-6, rtol=1e-6), outs[0], outs[1])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def _train(tcfg, params_np, batches, model=None, state=None):
    model = model or _model(tcfg, params_np)
    state = state or make_train_state(model)
    for b in batches:
        state, _ = train_step(model, state, _torch(b), **STEP_KW)
    return model, state


def test_bridge_round_trips_a_trained_model(family):
    """A trained model's tree has the reference's structure and leaf
    shapes, goes back into a model bit for bit, and gives the port's loss
    in the reference."""
    _, tcfg, params, params_np, vag = family
    batches = _batches(tcfg, 2)
    model, _ = _train(tcfg, params_np, batches[:1])
    tree = weights.to_numpy_params(model)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: a.shape == b.shape or pytest.fail("shape"),
                 tree, params_np)
    back = weights.from_jax_params(tcfg, tree, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a.detach(), b), n
    (want, _), _ = vag(jax.tree.map(jnp.asarray, tree), _jax(batches[1]))
    with torch.no_grad():
        got, _ = TM.apply_train(back, _torch(batches[1]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_checkpoint_restart_is_bit_exact(family, tmp_path):
    """Train 2 steps; vs train 1, save, restore into a fresh model, train
    1 more: parameters, moments (the recurrent blocks' fp32 a_log /
    dt_bias / w_gates included) and step bit for bit."""
    _, tcfg, _, params_np, _ = family
    batches = _batches(tcfg, 2)
    model_a, state_a = _train(tcfg, params_np, batches)
    model_b, state_b = _train(tcfg, params_np, batches[:1])
    C.save(str(tmp_path), state_tensors(model_b, state_b), step=1,
           data_state=DataState(seed=1, step=1))
    tensors, step, _ = C.restore(str(tmp_path))
    assert step == 1
    fresh = weights.init_random(tcfg, 5, device="cpu")
    state_c = load_state_tensors(fresh, tensors)
    model_c, state_c = _train(tcfg, params_np, batches[1:], fresh, state_c)
    a, c = state_tensors(model_a, state_a), state_tensors(model_c, state_c)
    assert a.keys() == c.keys()
    for key in a:
        torch.testing.assert_close(a[key], c[key], atol=0, rtol=0, msg=key)


def test_train_launcher_runs_both_families_on_cpu():
    """`launch.train`'s `main` for each family in one process (one import
    of torch for both)."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    runs = "; ".join(
        f"main(['--arch', '{arch}', '--reduced', '--device', 'cpu', "
        f"'--global-batch', '2', '--seq', '64', '--steps', '2'])"
        for arch in ARCHS)
    cmd = [sys.executable, "-c",
           f"from repro_torch.launch.train import main; {runs}"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [x for x in out.stdout.splitlines() if x.startswith("trained")]
    assert [x.split()[4] for x in lines] == [f"{a}-reduced" for a in ARCHS]
    for line in lines:
        assert "on the CPU" in line and "ssd kernel launches 0" in line
        assert "mlstm kernel launches 0" in line
    assert out.stdout.count("step 1 loss") == 2
