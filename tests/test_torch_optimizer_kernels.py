"""The optimizer step's kernels (`repro_torch.kernels.optimizer`) on the
CPU: the plain versions, which a CPU tensor runs and the card's kernels
are held to bit for bit, against the reference's `adamw_update` and
`global_norm` on identical numpy inputs; the host tables the kernels
read; the meta route; the refusals.

Tolerances are those of `test_torch_training.py`'s AdamW test: fp32
parameters and both moments within 1e-6; bf16 parameters within 2^-8
relative (the update runs in fp32 on both sides and is cast back, so an
fp32 value that XLA and PyTorch round one ulp apart may straddle a bf16
rounding boundary); the grad norm within 1e-6 relative (its sums are
taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro.utils import misc as JMISC
from repro_torch.kernels.optimizer import kernel as OK
from repro_torch.roofline import analysis as RA
from repro_torch.training import optimizer as TO

SHAPES = [(7, 5), (3,), (4, 2, 3), (1,)]
PAIRS = {"bf16/bf16": ("bfloat16", "bfloat16"),
         "fp32/fp32": ("float32", "float32"),
         "bf16/fp32": ("bfloat16", "float32")}


def _inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    p = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    g = [rng.standard_normal(s).astype(np.float32) * grad_scale
         for s in SHAPES]
    mu = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
    nu = [np.abs(rng.standard_normal(s)).astype(np.float32) * 0.1
          for s in SHAPES]
    return p, g, mu, nu


@pytest.mark.parametrize("count", [0, 3])
@pytest.mark.parametrize("clipped", [True, False])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_adamw_update_matches_reference(pair, clipped, count):
    """One step from optimizer count 0 (the first step) or 3, with the
    clip active (a grad norm near 9 against clip 1) or not (near 0.09)."""
    pd, gd = PAIRS[pair]
    p, g, mu, nu = _inputs(5 + count, 2.0 if clipped else 0.02)
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0)
    jp, jo, jm = JO.adamw_update(
        [jnp.asarray(x, getattr(jnp, gd)) for x in g],
        {"mu": [jnp.asarray(x) for x in mu],
         "nu": [jnp.asarray(x) for x in nu],
         "count": jnp.asarray(count, jnp.int32)},
        [jnp.asarray(x, getattr(jnp, pd)) for x in p], **kw)
    tp, to, tm = TO.adamw_update(
        [torch.from_numpy(x).to(getattr(torch, gd)) for x in g],
        {"mu": [torch.from_numpy(x) for x in mu],
         "nu": [torch.from_numpy(x) for x in nu],
         "count": torch.tensor(count, dtype=torch.int32)},
        [torch.from_numpy(x).to(getattr(torch, pd)) for x in p], **kw)
    gnorm = float(jm["grad_norm"])
    assert (gnorm > 1.0) == clipped
    rtol = 1e-6 if pd == "float32" else 2 ** -8
    for a, b in zip(tp, jp):
        assert a.dtype == getattr(torch, pd)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=1e-6,
                                   rtol=rtol)
    for name in ("mu", "nu"):
        for a, b in zip(to[name], jo[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    assert int(to["count"]) == int(jo["count"]) == count + 1
    np.testing.assert_allclose(float(tm["grad_norm"]), gnorm, rtol=1e-6)


def test_sum_squares_and_global_norm_match_reference():
    """Each tensor's sum of squares (bf16 and fp32 mixed) against the
    reference's leaves of `global_norm`, and the norm itself."""
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(s).astype(np.float32) * 3 for s in SHAPES]
    dts = ["bfloat16", "float32", "bfloat16", "float32"]
    jx = [jnp.asarray(x, getattr(jnp, d)) for x, d in zip(xs, dts)]
    tx = [torch.from_numpy(x).to(getattr(torch, d)) for x, d in zip(xs, dts)]
    sums = OK.sum_squares(tx)
    assert sums.dtype == torch.float32 and sums.shape == (len(SHAPES),)
    want = [float(jnp.sum(jnp.square(x.astype(jnp.float32)))) for x in jx]
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(TO.global_norm(tx)),
                               float(JMISC.global_norm(jx)), rtol=1e-6)


def test_first_chunks_and_tables():
    """Each tensor's chunks follow the previous tensor's; an empty tensor
    has none.  For every chunk, the last row whose first chunk is at most
    it (the kernels' binary search) is the row that holds it, also where
    empty tensors sit between, before and after others."""
    numels = [0, 5, 16, 17, 0, 1, 0]
    firsts, total = OK.first_chunks(numels, 8)
    assert firsts == [0, 0, 1, 3, 6, 6, 7] and total == 7
    for c in range(total):
        row = max(i for i, f in enumerate(firsts) if f <= c)
        assert firsts[row] <= c < firsts[row] + -(-numels[row] // 8)

    ts = [torch.zeros(n, dtype=torch.bfloat16 if i % 2 else torch.float32)
          for i, n in enumerate([3, 20, 8])]
    table, total = OK.sum_squares_table(ts, chunk=8)
    rows = table[:-1].reshape(-1, 4)
    assert total == 1 + 3 + 1 and table[-1] == 0 and table.dtype == np.int64
    assert rows[:, 0].tolist() == [t.data_ptr() for t in ts]
    assert rows[:, 1:].tolist() == [[3, 0, 0], [20, 1, 1], [8, 0, 4]]

    params = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros(9),
              torch.zeros(2, dtype=torch.bfloat16),
              torch.zeros(4, dtype=torch.bfloat16)]
    grads = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros(9),
             torch.zeros(2), torch.zeros(4, dtype=torch.bfloat16)]
    groups = OK.adamw_groups(params, grads)
    assert list(groups.items()) == [
        ((torch.bfloat16, torch.bfloat16), [0, 3]),
        ((torch.float32, torch.float32), [1]),
        ((torch.bfloat16, torch.float32), [2])]
    mus = [torch.zeros(p.shape) for p in params]
    nus = [torch.zeros(p.shape) for p in params]
    idx = groups[(torch.bfloat16, torch.bfloat16)]
    table, total = OK.adamw_table(*([ts[i] for i in idx] for ts in
                                    (params, grads, mus, nus)), chunk=4)
    assert total == 1 + 1 and table.shape == (2, 6)
    for col, ts in enumerate((params, grads, mus, nus)):
        assert table[:, col].tolist() == [ts[i].data_ptr() for i in idx]
    assert table[:, 4:].tolist() == [[3, 0], [4, 1]]


def test_meta_route_records_work_and_allocates_nothing():
    meta = dict(device="meta")
    ps = [torch.empty(6, 4, dtype=torch.bfloat16, **meta),
          torch.empty(5, **meta)]
    gs = [torch.empty(6, 4, dtype=torch.bfloat16, **meta),
          torch.empty(5, **meta)]
    mus = [torch.empty(p.shape, **meta) for p in ps]
    with RA.StepCounter() as c:
        sums = OK.sum_squares(gs)
        OK.adamw(ps, gs, mus, mus, scale=torch.empty((), **meta),
                 bc1=torch.empty((), **meta), bc2=torch.empty((), **meta),
                 lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    assert sums.shape == (2,) and sums.device.type == "meta"
    assert c.kernels["sum_squares"] == [
        1, *RA.sum_squares_work(elems=29, nbytes=24 * 2 + 5 * 4, n=2)]
    # one launch a (parameter, gradient) dtype group
    want = [RA.adamw_work(elems=24, p_bytes=2, g_bytes=2),
            RA.adamw_work(elems=5, p_bytes=4, g_bytes=4)]
    assert c.kernels["adamw"] == [2, *(a + b for a, b in zip(*want))]
    assert RA.adamw_work(elems=10, p_bytes=2, g_bytes=2)[1] == 10 * 22
    assert OK.LAUNCHES == {"sum_squares": 0, "adamw": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError):  # mixed devices
        OK.sum_squares([x, torch.empty(3, device="meta")])
    with pytest.raises(ValueError):  # not contiguous
        OK.sum_squares([x.t()])
    with pytest.raises(ValueError):
        OK.sum_squares([])
    with pytest.raises(TypeError):
        OK.sum_squares([x.double()])
    kw = dict(scale=torch.tensor(1.0), bc1=torch.tensor(0.1),
              bc2=torch.tensor(0.05), lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    m = torch.zeros(4, 6)
    with pytest.raises(ValueError):  # mixed devices
        OK.adamw([x], [torch.empty(4, 6, device="meta")], [m], [m], **kw)
    with pytest.raises(ValueError):  # a non-contiguous parameter
        OK.adamw([x.t()], [x.t().contiguous()], [m.t()], [m.t()], **kw)
    with pytest.raises(TypeError):  # fp32 parameters with bf16 gradients
        OK.adamw([x], [x.bfloat16()], [m], [m], **kw)
    with pytest.raises(TypeError):  # moments must be fp32
        OK.adamw([x], [x], [m.bfloat16()], [m], **kw)
    with pytest.raises(ValueError):
        OK.adamw([x], [torch.zeros(4, 5)], [m], [m], **kw)
