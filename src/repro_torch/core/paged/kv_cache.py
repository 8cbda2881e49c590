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


def physical_slots(page_table: torch.Tensor, positions: torch.Tensor,
                   valid: torch.Tensor, page_size: int,
                   pages_per_pool: int) -> torch.Tensor:
    """positions [S, T] in-sequence positions -> pool-local flat slots
    [S, T] through page_table [S, Np]; invalid entries -> the out-of-range
    trash slot `pages_per_pool * page_size` (dropped by the writes)."""
    pos = torch.clamp(positions.long(), min=0)
    page = torch.clamp(pos // page_size, max=page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, page) * page_size \
        + pos % page_size
    return torch.where(valid, phys, pages_per_pool * page_size)


def write_index(slots: torch.Tensor, slots_per_pool: int):
    """The KV write index of [G, N] pool-local slots, with shapes that
    depend on the input shape alone (no host sync, so a CUDA graph can
    capture it).  A negative slot counts from the pool's end, as numpy
    indexing does (the reference's `.at[]` normalises it so); slots that
    stay out of range (the engine's trash slot `num_pages * page_size`
    for padded tokens, or below `-slots_per_pool`) are DROPPED, the JAX
    reference's `mode="drop"`: a dropped row repeats the
    first live row's write (the same slot, the same value), and with no
    live row at all every row rewrites slot 0 of the NULL page 0 with the
    value already there.  So the pages end exactly as the reference
    leaves them.  Returns (src [G*N] the update row each row writes, dest
    [G*N] its flat pool row in [G * slots_per_pool], live [G*N] whether
    it writes an update, not the old value).  Computed once per step and
    reused by every layer's `scatter_kv`."""
    g, n = slots.shape
    slots = slots.long()
    slots = torch.where(slots < 0, slots + slots_per_pool, slots)
    keep = ((slots >= 0) & (slots < slots_per_pool)).reshape(-1)
    pool = torch.arange(g, device=slots.device)[:, None] * slots_per_pool
    dest = (pool + slots).reshape(-1)
    rows = torch.arange(g * n, device=slots.device)
    src = torch.where(keep, rows, torch.argmax(keep.to(torch.int32)))
    live = keep[src]
    return src, torch.where(live, dest[src], 0), live


def scatter_kv(pages: torch.Tensor, upd: torch.Tensor,
               index: tuple[torch.Tensor, torch.Tensor, torch.Tensor]) \
        -> torch.Tensor:
    """In-place row scatter: pages [Hkv, G, P, ps, D] (contiguous),
    upd [Hkv, G*N, D]; `index` = `write_index` of the slots."""
    src, dest, live = index
    hkv, g, p, ps, d = pages.shape
    flat = pages.view(hkv, g * p * ps, d)
    vals = torch.where(live[None, :, None],
                       upd.index_select(1, src).to(pages.dtype),
                       flat[:, :1])
    flat.index_copy_(1, dest, vals)
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
    return scatter_kv(pages, upd,
                      write_index(slots.reshape(g, b_loc * t), p * ps))


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[Hkv, G, P, ps, D] + [S, Np] -> [S, Np*ps, Hkv, D] dense per-seq KV."""
    hkv, g, p, ps, d = pages.shape
    s, np_ = page_table.shape
    b_loc = s // g
    pool = (torch.arange(s, device=page_table.device) // b_loc)[:, None]
    out = pages[:, pool, page_table.long()]  # [Hkv, S, Np, ps, D]
    return out.permute(1, 2, 3, 0, 4).reshape(s, np_ * ps, hkv, d)
