"""The port's sampler against the JAX reference on injected logits:
kept-token sets of the top-k / top-p filters (ties at the k-th value and
at the nucleus threshold), greedy argmax, the Gumbel-max draw with the
same injected noise on both sides, and draws that depend only on
(seed, stream, n_generated), never on the row a request lands in."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sampling as JS
from repro_torch.models import sampling as TS


def _logits():
    """Rows with deliberate ties: [5, 3, 3, 3, 1, ...] puts three logits
    at the top-2/3/4 boundary; [2, 2, 0, ...] splits the mass evenly
    between two tied leaders (top-p 0.5 must keep both)."""
    rng = np.random.default_rng(0)
    v = 32
    x = rng.standard_normal((6, v)).astype(np.float32)
    x[0, :5] = [5, 3, 3, 3, 1]
    x[1, :] = -8.0
    x[1, :3] = [2, 2, 0]
    x[2, 7] = x[2].max() + 1.0
    return x


CASES = [  # (temperature, top_p, top_k) per row
    ([1.0, 1.0, 0.7, 1.3, 0.0, 2.0], [1.0, 0.5, 0.9, 1.0, 0.3, 0.2],
     [2, 0, 0, 5, 3, 1]),
    ([0.5] * 6, [0.8] * 6, [3] * 6),
    ([1.0] * 6, [1.0] * 6, [0] * 6),
]


@pytest.mark.parametrize("temps,top_p,top_k", CASES)
def test_filter_logits_matches_reference(temps, top_p, top_k):
    x = _logits()
    args = (np.asarray(temps, np.float32), np.asarray(top_p, np.float32),
            np.asarray(top_k, np.int32))
    want = np.asarray(JS.filter_logits(jnp.asarray(x),
                                       *(jnp.asarray(a) for a in args)))
    got = TS.filter_logits(torch.from_numpy(x),
                           *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_filter_keeps_boundary_ties():
    x = torch.from_numpy(_logits())
    ones = torch.ones(6)
    kept = TS.apply_top_k(x, torch.full((6,), 2, dtype=torch.int32))
    assert torch.isfinite(kept[0]).sum() == 4  # 5 and the three tied 3s
    nucleus = TS.apply_top_p(x, 0.5 * ones)
    assert torch.isfinite(nucleus[1]).sum() == 2  # both tied leaders


def test_greedy_rows_take_raw_argmax():
    x = _logits()
    x[3, [4, 9]] = x[3].max() + 2.0  # tie: the first index wins
    n = x.shape[0]
    toks = TS.sample_tokens(torch.from_numpy(x), torch.zeros(n), torch.ones(n),
                            torch.zeros(n, dtype=torch.int32), None)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.argmax(x, -1))
    assert toks[3] == 4


@pytest.mark.parametrize("temps,top_p,top_k", CASES)
def test_draw_with_injected_noise_matches_reference_filter(temps, top_p,
                                                           top_k):
    x = _logits()
    rng = np.random.default_rng(1)
    noise = rng.gumbel(size=x.shape).astype(np.float32)
    args = (np.asarray(temps, np.float32), np.asarray(top_p, np.float32),
            np.asarray(top_k, np.int32))
    filt = np.asarray(JS.filter_logits(jnp.asarray(x),
                                       *(jnp.asarray(a) for a in args)))
    want = np.where(args[0] > 0, np.argmax(filt + noise, -1),
                    np.argmax(x, -1))
    got = TS.sample_tokens(torch.from_numpy(x),
                           *(torch.from_numpy(a) for a in args),
                           torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_draws_do_not_depend_on_row_placement():
    rng = np.random.default_rng(2)
    v = 64
    streams = [11, 5, 42, 7]
    ngen = [0, 3, 9, 1]
    logits = rng.standard_normal((4, v)).astype(np.float32)
    temps = torch.full((4,), 0.9)
    top_p = torch.full((4,), 0.95)
    top_k = torch.zeros(4, dtype=torch.int32)

    def draw(order):
        noise = TS.gumbel_noise(123, [streams[i] for i in order],
                                [ngen[i] for i in order], v, "cpu")
        toks = TS.sample_tokens(torch.from_numpy(logits[order]), temps,
                                top_p, top_k, noise)
        return {streams[i]: int(t) for i, t in zip(order, toks)}

    base = draw([0, 1, 2, 3])
    assert draw([2, 0, 3, 1]) == base
    assert draw([3, 2, 1, 0]) == base
    # a different draw counter or seed moves the noise
    a = TS.gumbel_noise(1, [5], [0], v, "cpu")
    assert not torch.equal(a, TS.gumbel_noise(1, [5], [1], v, "cpu"))
    assert not torch.equal(a, TS.gumbel_noise(2, [5], [0], v, "cpu"))
    assert torch.equal(a, TS.gumbel_noise(1, [5], [0], v, "cpu"))


def test_gumbel_noise_only_draws_requested_rows():
    noise = TS.gumbel_noise(0, [1, 2, 3], [0, 0, 0], 16, "cpu", rows=[1])
    assert (noise[0] == 0).all() and (noise[2] == 0).all()
    assert torch.isfinite(noise[1]).all() and (noise[1] != 0).any()
