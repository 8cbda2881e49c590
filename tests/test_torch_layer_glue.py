"""The packed step's per-layer glue (`repro_torch.kernels.layer_glue`)
against the reference on the CPU: each plain version (what a CPU tensor
runs, and what the card's kernel is held to) against the JAX functions
the reference's step fuses, on inputs made with numpy from a seed.

  add_rms_norm_plain   `rms_norm(x + delta)`: fp32 within 1e-6, bf16 x_new
                       bit for bit and h within one bf16 ulp (the mean of
                       squares is summed in another order)
  rope_write_kv_plain  `apply_rope` / `apply_mrope` of q and k (op by op:
                       a jitted reference's sin / cos differ at large
                       angles) plus `write_pages`, fp32, positions up to
                       99991, a negative slot, one below the pool, the
                       trash slot and a dead row: q and k within 2e-5, the
                       pages exactly `write_pages` of the rotated rows
  silu_mul_plain       `jax.nn.silu(g) * u`, also on a fused gate_up's
                       halves: fp32 within 1e-6 relative (a few ulps:
                       x sigmoid(x) against x / (1 + exp(-x))), bf16
                       within two ulps (the reference rounds sigmoid and
                       silu, the port silu once)

The wrappers route a CPU tensor to the plain version and a meta tensor to
empty outputs with their work recorded; they raise before a launch on
what the kernels do not take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paged import kv_cache as JKV
from repro.models import layers as JL
from repro_torch.core.paged.kv_cache import write_index
from repro_torch.kernels.layer_glue import kernel as GL
from repro_torch.models import layers as TL
from repro_torch.roofline import analysis as RA

T, HQ, HKV, D = 7, 4, 2, 16
PAGES, PS = 6, 4  # one pool: 24 slots
SPP = PAGES * PS
# the trash slot first (a dead row), a negative slot, one below the pool
SLOTS = [SPP, 5, -3, 0, 13, -SPP - 1, 7]
POSITIONS = [99991, 0, 1, 17, 5000, 65535, 2]
THETA = 10000.0
SECTIONS = (2, 3, 3)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element of x (fp32), 2^-133 at 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_delta", [True, False])
def test_add_rms_norm_plain_matches_reference(dtype, with_delta):
    rng = np.random.default_rng(0)
    d = 96
    x = rng.standard_normal((1, 5, d)).astype(np.float32)
    delta = rng.standard_normal((1, 5, d)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tdelta, tscale = (torch.from_numpy(a).to(tdt)
                          for a in (x, delta, scale))
    jx, jdelta = jnp.asarray(x, jdt), jnp.asarray(delta, jdt)
    jnew = jx + jdelta if with_delta else jx
    want = np.asarray(JL.rms_norm({"scale": jnp.asarray(scale, jdt)}, jnew,
                                  1e-5).astype(jnp.float32))
    h, x_new = GL.add_rms_norm_plain(tx, tdelta if with_delta else None,
                                     tscale, 1e-5)
    assert h.dtype == x_new.dtype == tdt and h.shape == tx.shape
    np.testing.assert_array_equal(as_np(x_new),
                                  np.asarray(jnew.astype(jnp.float32)))
    if dtype == "float32":
        np.testing.assert_allclose(as_np(h), want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(as_np(h) - want) <= bf16_ulp(want))
    # the wrapper on CPU tensors is the plain version
    h2, x_new2 = GL.add_rms_norm(tx, tdelta if with_delta else None, tscale,
                                 1e-5)
    assert torch.equal(h2, h) and torch.equal(x_new2, x_new)
    if not with_delta:
        assert x_new2 is tx


def rope_inputs(style: str, seed: int = 1):
    """q / k / v as views of one projection's output [T, (Hq + 2 Hkv) D],
    positions ([T], or [3, T] for M-RoPE), random pages, the write index
    of SLOTS."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((T, (HQ + 2 * HKV) * D)).astype(np.float32)
    pages = rng.standard_normal((2, HKV, 1, PAGES, PS, D)).astype(np.float32)
    if style == "mrope":
        pos = np.stack([np.asarray(POSITIONS), np.asarray(POSITIONS[::-1]),
                        np.arange(T) * 7919]).astype(np.int64)
    else:
        pos = np.asarray(POSITIONS, np.int64)
    return qkv, pos, pages


def rope_reference(style, q, k, pos):
    if style == "rope":
        return (JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), THETA),
                JL.apply_rope(jnp.asarray(k), jnp.asarray(pos), THETA))
    if style == "mrope":
        return (JL.apply_mrope(jnp.asarray(q), jnp.asarray(pos), THETA,
                               SECTIONS),
                JL.apply_mrope(jnp.asarray(k), jnp.asarray(pos), THETA,
                               SECTIONS))
    return jnp.asarray(q), jnp.asarray(k)


@pytest.mark.parametrize("style", ["rope", "mrope", "none"])
def test_rope_write_kv_plain_matches_reference(style):
    qkv, pos, pages = rope_inputs(style)
    tqkv = torch.from_numpy(qkv)
    q, k, v = (a.view(T, -1, D) for a in
               tqkv.split([HQ * D, HKV * D, HKV * D], dim=-1))
    kp, vp = (torch.from_numpy(pages[i].copy()) for i in range(2))
    slots = torch.tensor(SLOTS, dtype=torch.int64)[None]
    freqs = TL.rope_frequencies(D, THETA)
    tpos = torch.from_numpy(pos)
    q_rot = GL.rope_write_kv(q, k, v, tpos, freqs, kp, vp,
                             write_index(slots, SPP), style=style,
                             sections=SECTIONS)
    assert q_rot.shape == (T, HQ, D) and q_rot.is_contiguous()
    want_q, want_k = rope_reference(style, qkv[:, :HQ * D].reshape(T, HQ, D),
                                    qkv[:, HQ * D:(HQ + HKV) * D].reshape(
                                        T, HKV, D), pos)
    np.testing.assert_allclose(q_rot.numpy(), np.asarray(want_q), rtol=0,
                               atol=2e-5)
    # the pages: exactly the reference's write of the rotated K rows and
    # of V, at the same slots
    if style == "none":
        k_rows = k.numpy()
    elif style == "rope":
        k_rows = TL.apply_rope(k, tpos, freqs=freqs).numpy()
    else:
        k_rows = TL.apply_mrope(k, tpos, None, SECTIONS, freqs=freqs).numpy()
    np.testing.assert_allclose(k_rows, np.asarray(want_k), rtol=0, atol=2e-5)
    jslots = jnp.asarray(np.asarray(SLOTS)[None])
    for got, page0, new in ((kp, pages[0], k_rows),
                            (vp, pages[1], v.numpy())):
        ref = JKV.write_pages(jnp.asarray(page0), jnp.asarray(new[None]),
                              jslots)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the dead row and the slot below the pool wrote nothing: the NULL
    # page and every other untouched row keep their values
    written = {s % SPP for s in SLOTS if -SPP <= s < SPP}
    flat = kp.view(HKV, SPP, D).numpy()
    before = pages[0].reshape(HKV, SPP, D)
    for s in set(range(SPP)) - written:
        np.testing.assert_array_equal(flat[:, s], before[:, s])


def test_rope_write_kv_plain_frequencies_are_rope_frequencies():
    """The step's frequencies, computed once and passed in, give the bits
    of `apply_rope` computing its own."""
    qkv, pos, _ = rope_inputs("rope", seed=2)
    x = torch.from_numpy(qkv[:, :HQ * D]).view(T, HQ, D)
    tpos = torch.from_numpy(pos)
    assert torch.equal(TL.apply_rope(x, tpos, THETA),
                       TL.apply_rope(x, tpos, freqs=TL.rope_frequencies(
                           D, THETA)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_silu_mul_plain_matches_reference(dtype, fused):
    rng = np.random.default_rng(3)
    ff = 40
    gu = (rng.standard_normal((1, 6, 2 * ff)) * 4).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tgu = torch.from_numpy(gu).to(tdt)
    if fused:
        gate, up = tgu.chunk(2, dim=-1)  # views at row stride 2 ff
    else:
        gate, up = tgu[..., :ff].contiguous(), tgu[..., ff:].contiguous()
    jgu = jnp.asarray(gu, jdt)
    want = np.asarray((jax.nn.silu(jgu[..., :ff]) * jgu[..., ff:]).astype(
        jnp.float32))
    got = GL.silu_mul_plain(gate, up)
    assert got.dtype == tdt and got.shape == (1, 6, ff)
    if dtype == "float32":
        np.testing.assert_allclose(as_np(got), want, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(as_np(got) - want) <= 2 * bf16_ulp(want))
    assert torch.equal(GL.silu_mul(gate, up), got)


def test_meta_route_returns_shapes_and_records_work():
    meta = dict(device="meta")
    x = torch.empty(1, T, 64, dtype=torch.bfloat16, **meta)
    scale = torch.empty(64, dtype=torch.bfloat16, **meta)
    q = torch.empty(T, HQ, D, **meta)
    k = torch.empty(T, HKV, D, **meta)
    kp = torch.empty(HKV, 1, PAGES, PS, D, **meta)
    idx = (torch.empty(T, dtype=torch.int64, **meta),
           torch.empty(T, dtype=torch.int64, **meta),
           torch.empty(T, dtype=torch.bool, **meta))
    with RA.StepCounter() as c:
        h, x_new = GL.add_rms_norm(x, x, scale, 1e-5)
        q_rot = GL.rope_write_kv(q, k, k, torch.empty(T, dtype=torch.int64,
                                                      **meta),
                                 torch.empty(D // 2, **meta), kp, kp, idx,
                                 style="rope")
        g = GL.silu_mul(x, x)
    assert h.shape == x_new.shape == g.shape == x.shape
    assert q_rot.shape == (T, HQ, D) and q_rot.device.type == "meta"
    assert c.kernels["add_rms_norm"] == [
        1, *RA.add_rms_norm_work(rows=T, d=64, e=2, add=True)]
    assert c.kernels["rope_write_kv"] == [
        1, *RA.rope_write_kv_work(t=T, hq=HQ, hkv=HKV, d=D, e=4,
                                  style="rope", written=T)]
    assert c.kernels["silu_mul"] == [1, *RA.silu_mul_work(rows=T, ff=64,
                                                          e=2)]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        GL.add_rms_norm(x, torch.zeros(3, 9), torch.ones(8), 1e-5)
    with pytest.raises(TypeError):
        GL.add_rms_norm(x, None, torch.ones(8, dtype=torch.bfloat16), 1e-5)
    with pytest.raises(ValueError):
        GL.silu_mul(x, torch.zeros(3, 7))
    q, k = torch.zeros(T, HQ, D), torch.zeros(T, HKV, D)
    kp = torch.zeros(HKV, 1, PAGES, PS, D)
    idx = write_index(torch.zeros(1, T, dtype=torch.int64), SPP)
    pos = torch.zeros(T, dtype=torch.int64)
    freqs = torch.zeros(D // 2)
    with pytest.raises(ValueError):  # M-RoPE needs [3, T] positions
        GL.rope_write_kv(q, k, k, pos, freqs, kp, kp, idx, style="mrope",
                         sections=(2, 3, 3))
    with pytest.raises(ValueError):
        GL.rope_write_kv(q, k, k, pos, freqs, kp, kp, idx, style="yarn")
    with pytest.raises(ValueError):  # pages of another head count
        GL.rope_write_kv(q, k, k, pos, freqs, kp[:1], kp[:1], idx,
                         style="rope")
