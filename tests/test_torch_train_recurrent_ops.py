"""The training forms of the recurrent scans and blocks against the JAX
reference on the CPU, fp32, the same inputs drawn from a numpy seed:

  * `mamba2_ssd_trainable` against `ref.ssd_chunked` and `jax.grad` of it
    (groups 1 and 2, chunks 16 and 32): y within 3e-5 x max |y| (the SSD
    differential's tolerance), every input's gradient within 1e-5 x that
    gradient's largest element (fp32 sums in another order);
  * `mlstm_trainable` against `ref.mlstm_chunked` from the zero state and
    `jax.grad` of it (chunks 16 and 32, the forget gates drawn as
    tests/test_kernels_mlstm.py draws them: bias 2): h and every gradient
    within 1e-5 x the largest element; at the kernel tests' tiny forget
    gates against the exact scan (see that test);
  * each block's `forward_train` and the gradients of its input and of
    every parameter against `mamba2_block` / `mlstm_block` / `slstm_block`
    in mode "train" (reduced zamba2 / xlstm), at 1e-4, the block tests'
    tolerance;
  * the Functions call their kernel wrapper once a forward and never in
    the backward, and twice a step under `torch.utils.checkpoint` (the
    forward and its recompute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.kernels.mamba2 import ref as JSSD
from repro.kernels.mlstm import ref as JMLSTM
from repro.models import ssm_blocks as JS
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels.mamba2 import ops as SO
from repro_torch.kernels.mlstm import ops as MO
from repro_torch.models import ssm_blocks as TS

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _grads_match(tensors, want_grads, what):
    for i, (t, g) in enumerate(zip(tensors, want_grads)):
        g = np.asarray(g)
        assert t.grad is not None, (what, i)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=f"{what}: input {i}")


def _ssd_inputs(groups, seed=0, b=2, l=64, h=4, p=16, n=8):
    rng = np.random.default_rng(seed)
    x = _f32(rng, b, l, h, p)
    dt = np.log1p(np.exp(_f32(rng, b, l, h) - 1.0)).astype(np.float32)
    a = -np.exp(0.5 * _f32(rng, h)).astype(np.float32)
    return (x, dt, a, _f32(rng, b, l, groups, n), _f32(rng, b, l, groups, n),
            _f32(rng, h)), _f32(rng, b, l, h, p)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_trainable_matches_reference_grad(groups, chunk):
    inputs, w = _ssd_inputs(groups)

    def loss(*args):
        return jnp.sum(JSSD.ssd_chunked(*args, chunk=chunk)[0] * w)

    want_y = np.asarray(JSSD.ssd_chunked(*inputs, chunk=chunk)[0])
    want_g = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*inputs)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    y = SO.mamba2_ssd_trainable(*ts, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0,
                               atol=3e-5 * float(np.abs(want_y).max()))
    (y * torch.from_numpy(w)).sum().backward()
    _grads_match(ts, want_g, f"ssd G {groups} Q {chunk}")


def _mlstm_inputs(fgate_bias, seed=1, b=2, l=64, h=2, p=16):
    rng = np.random.default_rng(seed)
    q, k, v = _f32(rng, b, l, h, p), _f32(rng, b, l, h, p), _f32(rng, b, l,
                                                                 h, p)
    ig, fg = _f32(rng, b, l, h), _f32(rng, b, l, h) + np.float32(fgate_bias)
    return (q, k, v, ig, fg), _f32(rng, b, l, h, p)


@pytest.mark.parametrize("chunk", [16, 32])
def test_mlstm_trainable_matches_reference_grad(chunk):
    """The forget gates as the kernel tests draw them (bias 2)."""
    inputs, w = _mlstm_inputs(2.0)

    def loss(*args):
        return jnp.sum(JMLSTM.mlstm_chunked(*args, chunk=chunk)[0] * w)

    want_h = np.asarray(JMLSTM.mlstm_chunked(*inputs, chunk=chunk)[0])
    want_g = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*inputs)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    h = MO.mlstm_trainable(*ts, chunk=chunk)
    np.testing.assert_allclose(h.detach().numpy(), want_h, rtol=0,
                               atol=1e-5 * float(np.abs(want_h).max()))
    (h * torch.from_numpy(w)).sum().backward()
    _grads_match(ts, want_g, f"mlstm Q {chunk}")


def test_mlstm_trainable_tiny_forget_gates():
    """The kernel tests' extreme case (forget bias -18: the stabiliser
    resets at every token).  The reference's chunked form has no usable
    gradient there: its exps above the diagonal overflow before its mask,
    and its forget-gate and input-gate gradients are NaN.  So the oracle
    is the exact per-token recurrence `ref.mlstm_scan_ref`: h and the
    gradients of q, k, v and the input gate within 1e-5 x max.  The
    forget gate's gradient is finite; in fp32 it is cancellation-limited
    (the chunked form's +b_i and -b_j paths, each ~18 x the chunk, cancel
    to O(1)): 6.4e-2 of its max from an fp64 scan at chunk 16, where the
    same form in fp64 is within 1.3e-10, so it is checked for finiteness
    only."""
    inputs, w = _mlstm_inputs(-18.0)

    def loss(*args):
        return jnp.sum(JMLSTM.mlstm_scan_ref(*args)[0] * w)

    want_h = np.asarray(JMLSTM.mlstm_scan_ref(*inputs)[0])
    want_g = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*inputs)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    h = MO.mlstm_trainable(*ts, chunk=16)
    np.testing.assert_allclose(h.detach().numpy(), want_h, rtol=0,
                               atol=1e-5 * float(np.abs(want_h).max()))
    (h * torch.from_numpy(w)).sum().backward()
    _grads_match(ts[:4], want_g[:4], "mlstm tiny forget gates")
    assert torch.isfinite(ts[4].grad).all()


def test_recompute_forms_equal_the_forward_wrappers():
    """The backward differentiates what the forward computed: on the CPU
    the recompute forms give the plain kernels' y / h (fp32, 1e-5)."""
    (x, dt, a, b, c, d), _ = _ssd_inputs(2)
    ts = [torch.from_numpy(t) for t in (x, dt, a, b, c, d)]
    torch.testing.assert_close(SO.ssd_chunked_recompute(*ts, chunk=16),
                               SO.mamba2_ssd(*ts, chunk=16)[0], atol=1e-5,
                               rtol=1e-5)
    ts = [torch.from_numpy(t) for t in _mlstm_inputs(2.0)[0]]
    torch.testing.assert_close(MO.mlstm_chunked_recompute(*ts, chunk=16),
                               MO.mlstm_chunked(*ts, chunk=16)[0], atol=1e-5,
                               rtol=1e-5)


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module.K, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return real(*args, **kw)
    monkeypatch.setattr(module.K, name, wrapped)
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_kernel_called_once_a_forward_never_in_the_backward(monkeypatch,
                                                            remat):
    ssd_calls = _counting(monkeypatch, SO, "ssd_chunked_fwd")
    mlstm_calls = _counting(monkeypatch, MO, "mlstm_chunked_fwd")
    (x, dt, a, b, c, d), _ = _ssd_inputs(1)
    ssd_in = [torch.from_numpy(t).requires_grad_(True)
              for t in (x, dt, a, b, c, d)]
    mlstm_in = [torch.from_numpy(t).requires_grad_(True)
                for t in _mlstm_inputs(2.0)[0]]
    cases = ((ssd_calls, ssd_in,
              lambda *t: SO.mamba2_ssd_trainable(*t, chunk=16)),
             (mlstm_calls, mlstm_in,
              lambda *t: MO.mlstm_trainable(*t, chunk=16)))
    for calls, ts, fn in cases:
        out = checkpoint(fn, *ts, use_reentrant=False) if remat else fn(*ts)
        assert len(calls) == 1
        out.square().sum().backward()
        assert len(calls) == (2 if remat else 1)
        assert all(t.grad is not None for t in ts)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _block(arch, jinit, tblock, leaves):
    """(jcfg, the reference block's params from `jinit`, the port's block
    holding the same values, gradients on) at reduced `arch` in fp32."""
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    blk = tblock(tcfg)
    with torch.no_grad():
        for path, t in leaves(blk):
            src = jp
            for key in path:
                src = src[key]
            t.copy_(torch.from_numpy(np.array(src)))
    return jcfg, jp, blk.requires_grad_(True)


def _block_vs_reference(arch, jinit, jfn, tblock, leaves, seed):
    """forward_train's output and the gradients of u and of every
    parameter of the block (paths from `leaves`) against jax.grad of the
    reference block in mode "train", loss = sum(out * w)."""
    jcfg, jp, blk = _block(arch, jinit, tblock, leaves)
    rng = np.random.default_rng(seed)
    u = _f32(rng, 2, 64, jcfg.d_model)
    w = _f32(rng, 2, 64, jcfg.d_model)

    def loss(p, u):
        out, _ = jfn(jcfg, p, u, mode="train")
        return jnp.sum(out * w), out

    (_, want), (gp, gu) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, u)
    ut = torch.from_numpy(u).requires_grad_(True)
    out = blk.forward_train(ut)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu), **MODEL_TOL)
    n = 0
    for path, t in leaves(blk):
        ref = gp
        for key in path:
            ref = ref[key]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   err_msg=".".join(path), **MODEL_TOL)
        n += 1
    assert n == len(list(blk.parameters()))


def test_mamba2_block_forward_train_matches_reference():
    _block_vs_reference("zamba2-1.2b", JS.init_mamba2_block, JS.mamba2_block,
                        TS.Mamba2Block, weights._mamba_leaves, seed=2)


def test_mlstm_block_forward_train_matches_reference():
    _block_vs_reference("xlstm-350m", JS.init_mlstm_block, JS.mlstm_block,
                        TS.MLSTMBlock, weights._mlstm_leaves, seed=3)


def test_slstm_block_forward_train_matches_reference():
    _block_vs_reference("xlstm-350m", JS.init_slstm_block, JS.slstm_block,
                        TS.SLSTMBlock, weights._slstm_leaves, seed=4)
