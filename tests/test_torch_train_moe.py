"""MoE and MLA training of the port against the JAX reference on the CPU,
fp32: reduced deepseek-v2-236b (4 layers, d 256, 32 MLA heads, q_lora 64,
kv_lora 64, nope 32, rope 32, v 64, 4 experts top-2 of ff 128, 2 shared),
also with `first_k_dense=1` (a leading dense block in `lead_blocks`), and
reduced llama4-maverick-400b-a17b (4 layers, 10 / 2 GQA heads, 4 experts
top-1, 1 shared); weights carried across by `weights.from_jax_params`,
data from `MarkovDataset`:

  * `apply_train`, the dispatch einsum in fp32 on both sides (patched at
    run time): the loss (ce + the blocks' aux) at atol 1e-5, aux at 1e-5
    relative, every gradient leaf at rtol 1e-5 with an atol of 2e-6 of
    the leaf's largest element;
  * `apply_train` as the reference runs it (its bf16 dispatch): the loss
    at 1e-4, each leaf within one bf16 ulp (the rounding is held exactly
    on identical inputs by `test_torch_train_layers.py`);
  * on deepseek-v2's layout cut to 2 layers (its dense block, one MoE
    block): 3 `train_step`s against `make_train_step` with the fp32
    dispatch (loss 1e-4, as the dense test: a cross-framework AdamW step
    is brittle), the weight bridge round trip on a trained model and a
    bit-exact checkpoint restart (lead block and expert moments
    included);
  * the in-place AdamW bit for bit against the whole-tensor, list-building
    form it replaced (an inline copy), bf16 and fp32, sliced and whole;
  * `launch.train --arch deepseek-v2-236b --reduced --device cpu`.
"""
import dataclasses
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
from repro.models import moe as JMOE
from repro.training import optimizer as JO
from repro.training.trainer import make_train_step
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels.optimizer import kernel as OK
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as TO
from repro_torch.training.data import DataState, MarkovDataset
from repro_torch.training.trainer import (
    load_state_tensors, make_train_state, state_tensors, train_step,
)
from repro_torch.training.optimizer import global_norm

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
DSV2, MAV = "deepseek-v2-236b", "llama4-maverick-400b-a17b"
STEP_KW = dict(base_lr=1e-2, warmup=5, total_steps=60)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models are tiny: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(arch, lead, layers=4):
    """(jcfg, tcfg, params, params_np) of the reduced arch in fp32 with
    `layers` layers; with `lead`, block 0 becomes a leading dense block
    (its attention, a SwiGLU MLP drawn with numpy) and the MoE blocks
    follow it."""
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32", num_layers=layers)
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32", num_layers=layers)
    params = JM.init(jcfg, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    if not lead:
        return jcfg, tcfg, params, params_np
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, first_k_dense=1))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, first_k_dense=1))
    rng = np.random.default_rng(2)
    d, f = tcfg.d_model, tcfg.d_ff
    blocks = params_np["blocks"]
    block0 = jax.tree.map(lambda a: a[0],
                          {k: v for k, v in blocks.items() if k != "moe"})
    block0["mlp"] = {k: {"w": (rng.standard_normal(s) * s[0] ** -0.5
                               ).astype(np.float32)}
                     for k, s in (("gate", (d, f)), ("up", (d, f)),
                                  ("down", (f, d)))}
    params_np = dict(params_np, lead_blocks=[block0],
                     blocks=jax.tree.map(lambda a: a[1:], blocks))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params_np), params_np


VARIANTS = {"deepseek-v2": (DSV2, False), "deepseek-v2-lead": (DSV2, True),
            "maverick": (MAV, False)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def built(request):
    return _build(*VARIANTS[request.param])


@pytest.fixture(scope="module")
def dsv2_lead():
    """deepseek-v2's layout cut to 2 layers: its dense block, one MoE."""
    return _build(DSV2, True, layers=2)


def _batches(cfg, n, batch_size=2, seq_len=32):
    ds = MarkovDataset(cfg.vocab_size, seed=1)
    dstate, out = DataState(seed=1), []
    for _ in range(n):
        b, dstate = ds.batch(dstate, batch_size=batch_size, seq_len=seq_len)
        out.append(b)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _model(tcfg, params_np):
    return weights.from_jax_params(tcfg, params_np, device="cpu")


class _Fp32Dispatch:
    """`jax.numpy` as `repro.models.moe` sees it, with bfloat16 read as
    float32: the reference's dispatch einsum in fp32, no file edited."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def fp32_dispatch(monkeypatch):
    """Both sides' dispatch in fp32: the MoE becomes smooth in its input,
    so the whole model compares at fp32 tolerances."""
    monkeypatch.setattr(JMOE, "jnp", _Fp32Dispatch())
    monkeypatch.setattr(TMOE, "DISPATCH_DTYPE", torch.float32)


def _loss_and_grads(built, batch):
    jcfg, tcfg, params, params_np = built
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.apply_train(jcfg, p, jb), has_aux=True))(params)
    model = _model(tcfg, params_np).requires_grad_(True)
    loss, m = TM.apply_train(model, _torch(batch))
    loss.backward()
    assert float(jm["aux"]) > 0
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5)
    assert int(m["tokens"]) == int(jm["tokens"]) == 2 * 32 - 5
    got = jax.tree_util.tree_leaves_with_path(
        weights.to_numpy_params(model, grads=True))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got) == len(ref)
    return loss.item(), float(want), [
        (jax.tree_util.keystr(path), g, np.asarray(ref[path]))
        for path, g in got]


def _masked_batch(tcfg):
    batch = _batches(tcfg, 1)[0]
    batch["labels"] = batch["labels"].copy()  # a view into the inputs
    batch["labels"][0, :5] = -1  # ignored positions
    return batch


def test_apply_train_matches_reference_fp32_dispatch(built, fp32_dispatch):
    """The loss at 1e-5 and every gradient leaf at rtol 1e-5 with an atol
    of 2e-6 of its largest element (fp32 sums in another order)."""
    got, want, leaves = _loss_and_grads(built, _masked_batch(built[1]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for what, g, ref in leaves:
        np.testing.assert_allclose(
            g, ref, rtol=1e-5, err_msg=what,
            atol=2e-6 * max(1.0, float(np.abs(ref).max())))


def test_apply_train_matches_reference(built):
    """The reference's own bf16 dispatch: it rounds each dispatched
    activation and each dispatched gradient to bf16, so an fp32 difference
    of one rounding can move one of them by a bf16 ulp (2^-8), and the
    move spreads to every leaf upstream.  So the loss at 1e-4 and each
    leaf within one bf16 ulp: relative L2 error <= 2^-8, no element off by
    more than 2^-7 of the leaf's largest (measured: <= 3.7e-5 and <=
    2.2e-3 / 2.3e-3 at these 4 layers)."""
    got, want, leaves = _loss_and_grads(built, _masked_batch(built[1]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for what, g, ref in leaves:
        rel = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= 2 ** -8, (what, rel)
        assert np.abs(g - ref).max() <= 2 ** -7 * np.abs(ref).max(), what


def test_train_steps_match_reference(dsv2_lead, fp32_dispatch):
    """3 steps, the dispatch in fp32 on both sides (an AdamW step turns a
    bf16 rounding flip into a step of lr on an element): losses at 1e-4 as
    the dense test, aux at 1e-4 relative."""
def _adamw_list_form(grads, opt_state, params, *, lr, b1=0.9, b2=0.95,
                     eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """The whole-tensor, list-building AdamW the in-place update replaced
    (as it stood), for the bit-for-bit comparison."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    new_p, new_mu, new_nu = [], [], []
    for g, mu, nu, p in zip(grads, opt_state["mu"], opt_state["nu"], params):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        step_ = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        step_ = step_ + weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * step_).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}, gnorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1 << 26, 7])
def test_inplace_adamw_equals_list_form(dtype, chunk, monkeypatch):
    """Slices of 7 elements cut every tensor off its rows; the default
    takes each whole.  Parameters, moments and the grad norm bit for bit,
    the update written into the caller's tensors."""
    monkeypatch.setattr(OK, "UPDATE_CHUNK", chunk)
    rng = np.random.default_rng(3)
    shapes = [(8, 5), (3,), (4, 2, 3), (1,)]
    td = getattr(torch, dtype)
    p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(td)
         for s in shapes]
    g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 2
                          ).to(td) for s in shapes]
    mu = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
          for s in shapes]
    nu = [torch.from_numpy(np.abs(rng.standard_normal(s)).astype(np.float32)
                           * 0.1) for s in shapes]
    count = torch.tensor(3, dtype=torch.int32)
    kw = dict(lr=torch.tensor(3e-3), weight_decay=0.1, clip_norm=1.0)
    want_p, want_o, want_n = _adamw_list_form(
        g, {"mu": mu, "nu": nu, "count": count}, p, **kw)
    got_p, got_o, got_m = TO.adamw_update(
        g, {"mu": [t.clone() for t in mu], "nu": [t.clone() for t in nu],
            "count": count}, [t.clone() for t in p], **kw)
    for a, b in zip(got_p + got_o["mu"] + got_o["nu"],
                    want_p + want_o["mu"] + want_o["nu"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got_o["count"]) == 4
    assert torch.equal(got_m["grad_norm"], want_n)
    # in place: the caller's own tensors hold the result
    p2, mu2, nu2 = ([t.clone() for t in x] for x in (p, mu, nu))
    TO.adamw_update(g, {"mu": mu2, "nu": nu2, "count": count}, p2, **kw)
    for a, b in zip(p2 + mu2 + nu2, want_p + want_o["mu"] + want_o["nu"]):
        assert torch.equal(a, b)


def test_global_norm_sliced_matches_whole(monkeypatch):
    from repro_torch.kernels.optimizer import kernel as OK

    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((30, 7), (5,))]
    whole = global_norm(ts)
    monkeypatch.setattr(OK, "NORM_CHUNK", 16)
    torch.testing.assert_close(global_norm(ts), whole, rtol=1e-6,
                               atol=0)


def _train(tcfg, params_np, batches, model=None, state=None):
    model = model or _model(tcfg, params_np)
    state = state or make_train_state(model)
    for b in batches:
        state, _ = train_step(model, state, _torch(b), **STEP_KW)
    return model, state


def test_bridge_round_trips_a_trained_model(dsv2_lead, fp32_dispatch):
    """A trained model's tree has the reference's structure and leaf
    shapes, goes back into a model bit for bit, and gives the port's loss
    in the reference (1e-5: the dispatch in fp32 on both sides)."""
    jcfg, tcfg, params, params_np = dsv2_lead
    model, _ = _train(tcfg, params_np, _batches(tcfg, 1))
    tree = weights.to_numpy_params(model)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: a.shape == b.shape or pytest.fail("shape"),
                 tree, params_np)
    back = weights.from_jax_params(tcfg, tree, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a.detach(), b), n
    # the trained tree runs in the reference and gives the port's loss
    batch = _batches(tcfg, 2)[1]
    want, _ = jax.jit(lambda p, b: JM.apply_train(jcfg, p, b))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = TM.apply_train(back, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)


def test_checkpoint_restart_is_bit_exact(dsv2_lead, tmp_path):
    """Train 3 steps; vs train 1, save, restore into a fresh model, train
    2 more: parameters, moments (the lead block's and the experts') and
    step bit for bit."""
    _, tcfg, _, params_np = dsv2_lead
    batches = _batches(tcfg, 3)
    model_a, state_a = _train(tcfg, params_np, batches)
    model_b, state_b = _train(tcfg, params_np, batches[:1])
    C.save(str(tmp_path), state_tensors(model_b, state_b), step=1,
           data_state=DataState(seed=1, step=1))
    tensors, step, _ = C.restore(str(tmp_path))
    assert step == 1
    assert any(k.startswith("opt/mu/lead_blocks.0.") for k in tensors)
    assert any(k.endswith("moe.w_gate") and k.startswith("opt/nu/")
               for k in tensors)
    fresh = weights.init_random(tcfg, 5, device="cpu")
    state_c = load_state_tensors(fresh, tensors)
    model_c, state_c = _train(tcfg, params_np, batches[1:], fresh, state_c)
    a, c = state_tensors(model_a, state_a), state_tensors(model_c, state_c)
    assert a.keys() == c.keys()
    for key in a:
        torch.testing.assert_close(a[key], c[key], atol=0, rtol=0, msg=key)


def test_train_launcher_runs_deepseek_on_cpu():
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           DSV2, "--reduced", "--device", "cpu", "--global-batch", "2",
           "--seq", "32", "--steps", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 1 loss" in out.stdout and "on the CPU" in out.stdout
    assert "aux" in out.stdout and "flash kernel launches 0" in out.stdout
