"""The port's mLSTM pieces against the JAX reference on the CPU, with the
same inputs drawn from a numpy seed:

  * `mlstm_chunked` (which reaches the plain version of the mLSTM kernel
    on a CPU tensor) against the jnp `mlstm_chunked` with and without an
    initial state, and against the Pallas op `mlstm` in interpret mode
    (zero state), on the cases of tests/test_kernels_mlstm.py and one at
    xlstm-350m's head dim 512 and chunk 64: h and the final (C, n, m) at
    atol / rtol 5e-5, the reference's own kernel tolerance;
  * the plain mLSTM kernel against the Pallas kernel on identical
    kernel-level inputs (bcum and g from the reference's own cumsum and
    cummax);
  * the shared `chunk_cumsum` bit for bit against `jnp.cumsum`;
  * `decode_step`, and `MLSTMBlock` / `SLSTMBlock` prefill (ragged rows)
    then decode (a dead slot) against `mlstm_block` / `slstm_block`:
    output and every cache leaf at 1e-4;
  * the extreme-gates case of the kernel tests stays finite and matches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.kernels.mlstm import decode_step as jdecode_step
from repro.kernels.mlstm import kernel as JK
from repro.kernels.mlstm import mlstm as jmlstm
from repro.kernels.mlstm import mlstm_chunked as jmlstm_chunked
from repro.models import model as JM
from repro.models import ssm_blocks as JS
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels._common import chunk_cumsum
from repro_torch.kernels.mlstm import kernel as TK
from repro_torch.kernels.mlstm import ops as tops
from repro_torch.models import ssm_blocks as TS

MLSTM_TOL = dict(atol=5e-5, rtol=5e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)

CASES = [
    # (B, L, H, P, chunk): tests/test_kernels_mlstm.py's cases ...
    (2, 64, 3, 16, 16),
    (1, 128, 4, 64, 32),
    (2, 32, 1, 32, 8),
    # ... and xlstm-350m's head dim and chunk
    (1, 256, 2, 512, 64),
]


def _make(rng, b, l, h, p, fgate_bias=2.0):
    """q, k, v, igate, fgate as the reference's kernel tests draw them."""
    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)
    return (mk(b, l, h, p), mk(b, l, h, p), mk(b, l, h, p), mk(b, l, h),
            mk(b, l, h) + np.float32(fgate_bias))


def _state(rng, b, h, p):
    """A nonzero finite initial state (C, n, m)."""
    return (0.1 * rng.standard_normal((b, h, p, p)).astype(np.float32),
            0.1 * rng.standard_normal((b, h, p)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_mlstm_chunked_matches_reference(case, with_state):
    b, l, h, p, q = case
    rng = np.random.default_rng(hash(case) % 2**31)
    args = _make(rng, b, l, h, p)
    st = _state(rng, b, h, p) if with_state else None
    h_ref, s_ref = jmlstm_chunked(
        *map(jnp.asarray, args), chunk=q,
        initial_state=None if st is None else tuple(map(jnp.asarray, st)))
    hs, s = tops.mlstm_chunked(
        *map(torch.from_numpy, args), chunk=q,
        initial_state=None if st is None else tuple(map(torch.from_numpy,
                                                        st)))
    _close(hs, h_ref, **MLSTM_TOL)
    for got, want in zip(s, s_ref):
        _close(got, want, **MLSTM_TOL)


@pytest.mark.parametrize("case", CASES)
def test_mlstm_chunked_matches_pallas_op(case):
    b, l, h, p, q = case
    rng = np.random.default_rng(hash(case) % 2**31)
    args = _make(rng, b, l, h, p)
    h_ref, s_ref = jmlstm(*map(jnp.asarray, args), chunk=q, interpret=True)
    hs, s = tops.mlstm_chunked(*map(torch.from_numpy, args), chunk=q)
    _close(hs, h_ref, **MLSTM_TOL)
    for got, want in zip(s, s_ref):
        _close(got, want, **MLSTM_TOL)


@pytest.mark.parametrize("case", CASES[1:])
def test_plain_kernel_matches_pallas_kernel(case):
    """Kernel-level inputs: k pre-scaled (scale 1), bcum and g from the
    reference's own cumsum and cummax, the zero state."""
    bsz, l, h, p, q = case
    nc = l // q
    rng = np.random.default_rng(7)
    qf, kf, vf, ig, fg = _make(rng, bsz, l, h, p)
    kf = kf * np.float32(p ** -0.5)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(fg)))
    bcum = np.array(jnp.cumsum(jnp.asarray(lf.reshape(bsz, nc, q, h)),
                               axis=2))
    g = np.array(jax.lax.cummax(
        jnp.asarray(ig.reshape(bsz, nc, q, h)) - bcum, axis=2))
    bcum, g = bcum.reshape(bsz, l, h), g.reshape(bsz, l, h)

    def kl(t):  # [B, L, H, .] -> the Pallas layout [B, H, nc, Q, .]
        return jnp.asarray(
            t.reshape(bsz, nc, q, h, -1).transpose(0, 3, 1, 2, 4))

    h_ref, c_ref, n_ref, m_ref = JK.mlstm_chunked_fwd(
        kl(qf), kl(kf), kl(vf), kl(ig[..., None])[..., 0],
        kl(bcum[..., None])[..., 0], kl(g[..., None])[..., 0],
        interpret=True)
    c0, n0, m0 = tops.zero_state(bsz, h, p, "cpu")
    hs, c, n, m = TK.mlstm_chunked_fwd(
        *map(torch.from_numpy, (qf, kf, vf, ig, bcum, g)), c0, n0, m0,
        chunk=q, scale=1.0)
    _close(hs, np.asarray(h_ref).transpose(0, 2, 3, 1, 4).reshape(
        bsz, l, h, p), **MLSTM_TOL)
    _close(c, c_ref, **MLSTM_TOL)
    _close(n, np.asarray(n_ref)[:, :, 0], **MLSTM_TOL)
    _close(m, np.asarray(m_ref)[:, :, 0], **MLSTM_TOL)


@pytest.mark.parametrize("q", [32, 64])
def test_chunk_cumsum_matches_reference_bit_for_bit(q):
    rng = np.random.default_rng(q)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(
        rng.standard_normal((8, 16, q, 4)).astype(np.float32) + 2.0)))
    want = np.asarray(jnp.cumsum(jnp.asarray(lf), axis=2))
    np.testing.assert_array_equal(chunk_cumsum(torch.from_numpy(lf)).numpy(),
                                  want)


def test_zero_state_is_the_reference_zero_state():
    """m0 = -inf with zero C, n gives the result of no initial state."""
    rng = np.random.default_rng(8)
    args = [torch.from_numpy(a) for a in _make(rng, 2, 32, 2, 16)]
    h_none, s_none = tops.mlstm_chunked(*args, chunk=8)
    h_zero, s_zero = tops.mlstm_chunked(
        *args, chunk=8, initial_state=tops.zero_state(2, 2, 16, "cpu"))
    assert torch.equal(h_none, h_zero)
    for a, b in zip(s_none, s_zero):
        assert torch.equal(a, b)


def test_extreme_gates_stable():
    """tests/test_kernels_mlstm.py::test_extreme_gates_stable's gates:
    huge input gates, tiny forget gates; no NaN, and the reference's
    1e-4 of that test."""
    rng = np.random.default_rng(31)
    q, k, v, ig, fg = _make(rng, 1, 32, 2, 16)
    ig, fg = ig * 30.0, fg - 20.0
    h_ref, _ = jmlstm_chunked(*map(jnp.asarray, (q, k, v, ig, fg)), chunk=8)
    hs, (c, n, m) = tops.mlstm_chunked(
        *map(torch.from_numpy, (q, k, v, ig, fg)), chunk=8)
    for t in (hs, c, n, m):
        assert torch.isfinite(t).all()
    _close(hs, h_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_decode_step_matches_reference(with_state):
    rng = np.random.default_rng(32)
    b, h, p = 2, 2, 16
    q, k, v, ig, fg = _make(rng, b, 1, h, p)
    st = _state(rng, b, h, p) if with_state else (
        np.zeros((b, h, p, p), np.float32), np.zeros((b, h, p), np.float32),
        np.full((b, h), -np.inf, np.float32))
    args = (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    h_ref, s_ref = jdecode_step(*map(jnp.asarray, args),
                                tuple(map(jnp.asarray, st)))
    hs, s = tops.decode_step(*map(torch.from_numpy, args),
                             tuple(map(torch.from_numpy, st)))
    _close(hs, h_ref, atol=3e-5, rtol=3e-5)
    for got, want in zip(s, s_ref):
        _close(got, want, atol=3e-5, rtol=3e-5)


@pytest.fixture(scope="module")
def xlstm():
    jcfg = jreduced(JARCHS["xlstm-350m"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["xlstm-350m"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _block_steps(jcfg, jfn, tblk, spec, *, with_lens):
    """Ragged prefill (one row padded) from the empty state, then two
    decode steps (the second with a dead slot), through one block: the
    output and every cache leaf at 1e-4."""
    rng = np.random.default_rng(13)
    b, s, d = 2, 32, jcfg.d_model
    u = rng.standard_normal((b, s + 2, d)).astype(np.float32)
    qlens = np.asarray([s, 19], np.int32)
    valid = np.arange(s)[None, :] < qlens[:, None]
    jcache = {k: jnp.zeros(v.shape, v.dtype) for k, v in spec.items()}
    jcache["m"] = jnp.full_like(jcache["m"], -jnp.inf)
    tcache = {k: torch.from_numpy(np.asarray(v)) for k, v in jcache.items()}

    def step(u_np, mode, valid_np, lens_np):
        nonlocal jcache, tcache
        kw = {"seq_lens": lens_np} if with_lens else {}
        out_ref, jcache = jfn(
            jcfg, jnp.asarray(u_np), mode=mode, cache=jcache,
            valid=jnp.asarray(valid_np),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        out, tcache = tblk(
            torch.from_numpy(u_np), mode=mode, cache=tcache,
            valid=torch.from_numpy(valid_np),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(out, out_ref, **MODEL_TOL)
        assert set(tcache) == set(jcache)
        for k in tcache:
            _close(tcache[k], jcache[k], err_msg=k, **MODEL_TOL)

    step(u[:, :s], "prefill", valid, qlens)
    live = np.asarray([True, True])
    step(u[:, s:s + 1], "decode", live[:, None], live.astype(np.int32))
    live = np.asarray([True, False])
    step(u[:, s + 1:s + 2], "decode", live[:, None], live.astype(np.int32))


def test_mlstm_block_prefill_then_decode_matches_reference(xlstm):
    jcfg, _, params, model = xlstm
    jp = jax.tree.map(lambda t: t[0], params["mlstm"])
    _block_steps(jcfg, lambda cfg, u, **kw: JS.mlstm_block(cfg, jp, u, **kw),
                 model.mlstm[0], JS.mlstm_cache_specs(jcfg, 2),
                 with_lens=True)


def test_slstm_block_prefill_then_decode_matches_reference(xlstm):
    jcfg, _, params, model = xlstm
    jp = jax.tree.map(lambda t: t[0], params["slstm"])
    _block_steps(jcfg, lambda cfg, u, **kw: JS.slstm_block(cfg, jp, u, **kw),
                 model.slstm[0], JS.slstm_cache_specs(jcfg, 2),
                 with_lens=False)


def test_block_cache_specs_match_reference(xlstm):
    jcfg, tcfg, _, _ = xlstm
    for jspec, tspec in ((JS.mlstm_cache_specs, TS.mlstm_cache_specs),
                         (JS.slstm_cache_specs, TS.slstm_cache_specs)):
        assert {k: (tuple(shape), str(dt).split(".")[-1])
                for k, (shape, dt) in tspec(tcfg, 3).items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jspec(jcfg, 3).items()}


def test_xlstm_train_mode_is_not_ported(xlstm):
    """The serving forward of both xLSTM blocks refuses mode "train":
    training runs through `forward_train`."""
    _, tcfg, _, model = xlstm
    u = torch.zeros((1, 4, tcfg.d_model))
    for blk in (model.mlstm[0], model.slstm[0]):
        with pytest.raises(NotImplementedError, match="training"):
            blk(u, mode="train", cache={})


def test_kernel_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(9)
    q, k, v, ig, fg = map(torch.from_numpy, _make(rng, 1, 16, 2, 8))
    state = tops.zero_state(1, 2, 8, "cpu")
    gates = (ig, ig, ig)
    with pytest.raises(TypeError, match="dtypes differ"):
        TK.mlstm_chunked_fwd(q, k.bfloat16(), v, *gates, *state, chunk=8,
                             scale=1.0)
    with pytest.raises(TypeError, match="float32"):
        TK.mlstm_chunked_fwd(q, k, v, ig.double(), ig, ig, *state, chunk=8,
                             scale=1.0)
    with pytest.raises(ValueError, match="divide"):
        TK.mlstm_chunked_fwd(q, k, v, *gates, *state, chunk=5, scale=1.0)
    with pytest.raises(ValueError, match="state"):
        TK.mlstm_chunked_fwd(q, k, v, *gates, state[0][:, :1], *state[1:],
                             chunk=8, scale=1.0)
