"""The port's paged KV primitives against the JAX reference, exactly:
`write_pages` drops out-of-range slots (the engine's trash slot
`num_pages * page_size` and beyond), `gather_pages` densifies per-sequence
KV through the page table, for one pool and for two."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paged import kv_cache as jkv
from repro_torch.core.paged import kv_cache as tkv


@pytest.mark.parametrize("pools", [1, 2])
def test_write_pages_drops_out_of_range_slots(pools):
    rng = np.random.default_rng(0)
    hkv, p, ps, d, b_loc, t = 2, 5, 4, 8, 2, 6
    s = pools * b_loc
    pages = rng.standard_normal((hkv, pools, p, ps, d)).astype(np.float32)
    new = rng.standard_normal((s, t, hkv, d)).astype(np.float32)
    trash = p * ps
    # distinct in-range slots per pool, plus the trash slot and beyond
    slots = np.concatenate([rng.permutation(trash)[: b_loc * t]
                            for _ in range(pools)]).reshape(s, t)
    slots[0, 1] = trash
    slots[-1, 0] = trash + 7
    slots[-1, -1] = trash
    slots = slots.astype(np.int32)
    want = jkv.write_pages(jnp.asarray(pages), jnp.asarray(new),
                           jnp.asarray(slots))
    got_pages = torch.from_numpy(pages.copy())
    got = tkv.write_pages(got_pages, torch.from_numpy(new),
                          torch.from_numpy(slots))
    assert got.data_ptr() == got_pages.data_ptr()  # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), pages)


def test_write_pages_all_trash_is_a_no_op():
    pages = torch.randn(1, 1, 3, 4, 8)
    before = pages.clone()
    slots = torch.full((1, 5), 12, dtype=torch.int32)
    tkv.write_pages(pages, torch.randn(1, 5, 1, 8), slots)
    assert torch.equal(pages, before)


@pytest.mark.parametrize("pools", [1, 2])
def test_gather_pages_matches_reference(pools):
    rng = np.random.default_rng(1)
    hkv, p, ps, d, b_loc, np_ = 3, 7, 4, 8, 2, 3
    s = pools * b_loc
    pages = rng.standard_normal((hkv, pools, p, ps, d)).astype(np.float32)
    pt = rng.integers(0, p, size=(s, np_)).astype(np.int32)
    want = jkv.gather_pages(jnp.asarray(pages), jnp.asarray(pt))
    got = tkv.gather_pages(torch.from_numpy(pages), torch.from_numpy(pt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_require_single_pool():
    tkv.require_single_pool(torch.zeros(2, 1, 3, 4, 8), "site")
    with pytest.raises(tkv.ShardingError, match="num_pools=2"):
        tkv.require_single_pool(torch.zeros(2, 2, 3, 4, 8), "site")
