"""Paged KV cache tensors + page read/write primitives.

Layout (stacked across attention layers, leading dim L):
  k_pages/v_pages : [L, Hkv, num_pools, pages_per_pool, page_size, D]
  page_table      : [S, pages_per_seq] int32, POOL-LOCAL page ids
  pool of seq s   : s // (S // num_pools)

Page 0 of every pool is the NULL page: never allocated, target of padded
block-table entries, so every launch keeps a static shape.

Unlike the JAX reference, whose arrays are immutable, the port writes the
cache IN PLACE: `write_pages` / `scatter_kv` update the page tensor they
are given and return it, so no second copy of the cache is ever made.
"""
from __future__ import annotations

import torch


class ShardingError(ValueError):
    """A launch or mesh configuration violates the sharding contract.

    Raised with the offending shapes in the message wherever a paged
    kernel requires a shard-local (single-pool) view, or where a launch
    layout cannot be split as requested.
    """


def require_single_pool(k_pages: torch.Tensor, site: str) -> None:
    """Paged kernels run on a shard-local pool view: [L?, Hkv, 1, P, ps, D]."""
    pool_axis = k_pages.ndim - 4
    if k_pages.shape[pool_axis] != 1:
        raise ShardingError(
            f"{site}: expected a shard-local single-pool KV view but got "
            f"num_pools={k_pages.shape[pool_axis]} (k_pages shape "
            f"{tuple(k_pages.shape)}); split the pool axis before launching "
            f"the kernel"
        )


def make_kv_cache(num_layers: int, num_kv_heads: int, num_pools: int,
                  pages_per_pool: int, page_size: int, head_dim: int,
                  dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """Zeroed {'k_pages', 'v_pages'} of shape
    [L, Hkv, num_pools, pages_per_pool, page_size, D]."""
    shape = (num_layers, num_kv_heads, num_pools, pages_per_pool, page_size,
             head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def live_slots(slots: torch.Tensor, slots_per_pool: int):
    """Split [G, N] pool-local slots into the (row, flat slot) pairs that
    land inside a pool: out-of-range slots (the engine's trash slot
    `num_pages * page_size` for padded tokens, or anything negative) are
    DROPPED, the JAX reference's `mode="drop"`.  Returns (rows [n] index
    into the flattened [G*N] updates, dest [n] index into the flattened
    [G * slots_per_pool] pool rows).  Computed once per step and reused
    by every layer's `scatter_kv` (the index selection synchronises with
    the device once)."""
    g, n = slots.shape
    slots = slots.long()
    keep = (slots >= 0) & (slots < slots_per_pool)
    pool = torch.arange(g, device=slots.device)[:, None].expand(g, n)
    dest = (pool * slots_per_pool + slots).reshape(-1)
    rows = torch.nonzero(keep.reshape(-1), as_tuple=True)[0]
    return rows, dest[rows]


def scatter_kv(pages: torch.Tensor, upd: torch.Tensor, rows: torch.Tensor,
               dest: torch.Tensor) -> torch.Tensor:
    """In-place row scatter: pages [Hkv, G, P, ps, D] (contiguous),
    upd [Hkv, G*N, D]; writes upd[:, rows] to flat pool rows `dest`."""
    hkv, g, p, ps, d = pages.shape
    flat = pages.view(hkv, g * p * ps, d)
    flat.index_copy_(1, dest, upd[:, rows].to(pages.dtype))
    return pages


def write_pages(pages: torch.Tensor, new: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """pages [Hkv, G, P, ps, D]; new [S, T, Hkv, D]; slots [S, T] pool-local
    flat slots, S = G * B_loc.  Writes IN PLACE and returns `pages`;
    out-of-range slots are dropped."""
    hkv, g, p, ps, d = pages.shape
    s, t = slots.shape
    b_loc = s // g
    upd = new.permute(2, 0, 1, 3).reshape(hkv, g * b_loc * t, d)
    rows, dest = live_slots(slots.reshape(g, b_loc * t), p * ps)
    return scatter_kv(pages, upd, rows, dest)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[Hkv, G, P, ps, D] + [S, Np] -> [S, Np*ps, Hkv, D] dense per-seq KV."""
    hkv, g, p, ps, d = pages.shape
    s, np_ = page_table.shape
    b_loc = s // g
    pool = (torch.arange(s, device=page_table.device) // b_loc)[:, None]
    out = pages[:, pool, page_table.long()]  # [Hkv, S, Np, ps, D]
    return out.permute(1, 2, 3, 0, 4).reshape(s, np_ * ps, hkv, d)
