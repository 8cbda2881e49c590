"""The port's Mamba2 pieces against the JAX reference on the CPU, with the
same inputs drawn from a numpy seed:

  * `mamba2_ssd` (which reaches the plain version of the SSD kernel on a
    CPU tensor) against the Pallas `mamba2_ssd` in interpret mode and the
    jnp `ssd_chunked`, on the cases of tests/test_kernels_mamba2.py and a
    zamba2-like case, with and without an initial state: y and the final
    state at atol / rtol 3e-5, the reference's own kernel tolerance;
  * the plain SSD kernel against the Pallas kernel on identical
    kernel-level inputs (3e-5);
  * `decode_step`, `causal_conv1d` (with a conv state and ragged
    `seq_lens`) and `Mamba2Block` prefill then decode against
    `S.mamba2_block`: output and both caches at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.kernels.mamba2 import kernel as JK
from repro.kernels.mamba2 import decode_step as jdecode_step
from repro.kernels.mamba2 import mamba2_ssd as jmamba2_ssd
from repro.kernels.mamba2 import ssd_chunked
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm_blocks as JS
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels.mamba2 import kernel as TK
from repro_torch.kernels.mamba2 import ops as tops
from repro_torch.models import layers as TL

SSD_TOL = dict(atol=3e-5, rtol=3e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)

CASES = [
    # (B, L, H, P, N, G, chunk): tests/test_kernels_mamba2.py's cases ...
    (2, 64, 4, 32, 16, 2, 16),
    (1, 128, 2, 64, 64, 1, 32),
    (2, 32, 8, 16, 8, 8, 8),
    # ... and zamba2's head and state widths at chunk 128
    (1, 256, 4, 128, 64, 1, 128),
]


def _make(rng, b, l, h, p, n, g):
    """x, dt, a, b, c, d as the reference's kernel tests draw them."""
    f32 = np.float32
    return (rng.standard_normal((b, l, h, p)).astype(f32),
            (np.abs(rng.standard_normal((b, l, h))) * 0.5 + 0.01).astype(f32),
            (-np.abs(rng.standard_normal(h)) - 0.1).astype(f32),
            rng.standard_normal((b, l, g, n)).astype(f32),
            rng.standard_normal((b, l, g, n)).astype(f32),
            rng.standard_normal(h).astype(f32))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_mamba2_ssd_matches_reference(case, with_state):
    b, l, h, p, n, g, q = case
    rng = np.random.default_rng(hash(case) % 2**31)
    args = _make(rng, b, l, h, p, n, g)
    s0 = (rng.standard_normal((b, h, n, p)).astype(np.float32)
          if with_state else None)
    jargs = [jnp.asarray(a) for a in args]
    js0 = None if s0 is None else jnp.asarray(s0)
    y, s = tops.mamba2_ssd(*map(torch.from_numpy, args), chunk=q,
                           initial_state=None if s0 is None
                           else torch.from_numpy(s0))
    for ref in (jmamba2_ssd, ssd_chunked):
        y_ref, s_ref = ref(*jargs, chunk=q, initial_state=js0)
        _close(y, y_ref, **SSD_TOL)
        _close(s, s_ref, **SSD_TOL)


@pytest.mark.parametrize("case", CASES[1:])
def test_plain_kernel_matches_pallas_kernel(case):
    """Kernel-level inputs: x = xdt with dt = 1 (so the port forms the
    same xdt), one group per head (so B / C need no repeat), a_cum from
    the reference's own cumsum."""
    bsz, l, h, p, n, _, q = case
    nc = l // q
    rng = np.random.default_rng(7)
    f32 = np.float32
    xdt = rng.standard_normal((bsz, l, h, p)).astype(f32)
    bm = rng.standard_normal((bsz, l, h, n)).astype(f32)
    cm = rng.standard_normal((bsz, l, h, n)).astype(f32)
    la = -(np.abs(rng.standard_normal((bsz, l, h))) * 0.5).astype(f32)
    a_cum = np.array(jnp.cumsum(jnp.asarray(la.reshape(bsz, nc, q, h)),
                                axis=2)).reshape(bsz, l, h)
    s0 = rng.standard_normal((bsz, h, n, p)).astype(f32)

    def kl(t):  # [B, L, H, .] -> the Pallas layout [B, H, nc, Q, .]
        return jnp.asarray(
            t.reshape(bsz, nc, q, h, -1).transpose(0, 3, 1, 2, 4))

    y_ref, s_ref = JK.ssd_chunked_fwd(
        kl(xdt), kl(bm), kl(cm), kl(a_cum[..., None])[..., 0],
        jnp.asarray(s0), interpret=True)
    y, s = TK.ssd_chunked_fwd(
        torch.from_numpy(xdt), torch.ones((bsz, l, h)), torch.from_numpy(bm),
        torch.from_numpy(cm), torch.from_numpy(a_cum), torch.from_numpy(s0),
        chunk=q)
    _close(y, np.asarray(y_ref).transpose(0, 2, 3, 1, 4).reshape(
        bsz, l, h, p), **SSD_TOL)
    _close(s, s_ref, **SSD_TOL)


def test_chunk_cumsum_matches_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    for q in (8, 16, 32, 128):
        la = -np.abs(rng.standard_normal((2, 3, q, 4))).astype(np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(la), axis=2))
        got = tops.chunk_cumsum(torch.from_numpy(la)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 2])
def test_decode_step_matches_reference(groups):
    rng = np.random.default_rng(11)
    b, h, p, n = 3, 4, 16, 8
    x, dt, a, bm, cm, d = _make(rng, b, 1, h, p, n, groups)
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    args = (x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], d, state)
    y_ref, s_ref = jdecode_step(*map(jnp.asarray, args))
    y, s = tops.decode_step(*map(torch.from_numpy, args))
    _close(y, y_ref, **SSD_TOL)
    _close(s, s_ref, **SSD_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_causal_conv1d_matches_reference(ragged):
    rng = np.random.default_rng(12)
    b, s, c, k = 3, 9, 6, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    state = rng.standard_normal((b, k - 1, c)).astype(np.float32)
    lens = np.asarray([9, 2, 0], np.int32) if ragged else None
    for st in (None, state):
        y_ref, ns_ref = JL.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if st is None else jnp.asarray(st),
            seq_lens=None if lens is None else jnp.asarray(lens))
        y, ns = TL.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            None if st is None else torch.from_numpy(st),
            seq_lens=None if lens is None else torch.from_numpy(lens))
        _close(y, y_ref, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(ns.numpy(), np.asarray(ns_ref))


def test_mamba2_block_prefill_then_decode_matches_reference():
    """Ragged prefill (one row padded) from zero state, then two decode
    steps (the second with a dead slot) through one reduced-zamba2 Mamba2
    block: outputs and the conv / ssm caches."""
    jcfg = jreduced(JARCHS["zamba2-1.2b"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["zamba2-1.2b"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    model = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    jp = jax.tree.map(lambda t: t[0], params["mamba"])
    blk = model.mamba[0]
    rng = np.random.default_rng(13)
    b, s, d = 2, 32, jcfg.d_model
    u = rng.standard_normal((b, s + 2, d)).astype(np.float32)
    qlens = np.asarray([s, 19], np.int32)
    valid = np.arange(s)[None, :] < qlens[:, None]
    spec = JS.mamba2_cache_specs(jcfg, b)
    jcache = {k: jnp.zeros(v.shape, v.dtype) for k, v in spec.items()}
    tcache = {k: torch.zeros(v.shape) for k, v in spec.items()}

    def step(u_np, mode, valid_np, lens_np):
        nonlocal jcache, tcache
        out_ref, jcache = JS.mamba2_block(
            jcfg, jp, jnp.asarray(u_np), mode=mode, cache=jcache,
            valid=jnp.asarray(valid_np), seq_lens=jnp.asarray(lens_np))
        out, conv, ssm = blk(
            torch.from_numpy(u_np), mode=mode, conv_state=tcache["conv"],
            ssm_state=tcache["ssm"], valid=torch.from_numpy(valid_np),
            seq_lens=torch.from_numpy(lens_np))
        tcache = {"conv": conv, "ssm": ssm}
        _close(out, out_ref, **MODEL_TOL)
        for k in tcache:
            _close(tcache[k], jcache[k], **MODEL_TOL)

    step(u[:, :s], "prefill", valid, qlens)
    live = np.asarray([True, True])
    step(u[:, s:s + 1], "decode", live[:, None], live.astype(np.int32))
    live = np.asarray([True, False])
    step(u[:, s + 1:s + 2], "decode", live[:, None], live.astype(np.int32))


def test_mamba2_block_train_mode_is_not_ported():
    """The serving forward refuses mode "train": training runs through
    `forward_train`."""
    cfg = treduced(TARCHS["zamba2-1.2b"]).replace(dtype="float32")
    model = weights.init_random(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        model.mamba[0](torch.zeros((1, 4, cfg.d_model)), mode="train",
                       conv_state=None, ssm_state=None)
