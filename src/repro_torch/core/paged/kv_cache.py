"""Paged KV cache tensors + page read/write primitives.

Layout (stacked across attention layers, leading dim L):
  k_pages/v_pages : [L, Hkv, num_pools, pages_per_pool, page_size, D]
                    (MLA: k_pages only, Hkv 1, rows [latent | k_rope])
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
    kernel requires a shard-local (single-pool) view, or where a mesh
    executor cannot split the model as requested (head counts not
    divisible by tp, a process group of the wrong size, an unsupported
    engine path).
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


def local_kv_heads(num_kv_heads: int, num_devices: int,
                   *, num_q_heads: int | None = None) -> int:
    """Per-rank KV head count under head-axis tensor parallelism.

    Whole heads per rank keep every page gather rank-local and the math
    that of one device, so both head counts must divide evenly."""
    if num_kv_heads % num_devices:
        raise ShardingError(
            f"cannot shard num_kv_heads={num_kv_heads} across "
            f"tp={num_devices} devices: the KV pool is split on the head "
            f"axis in whole heads (num_kv_heads % tp must be 0)"
        )
    if num_q_heads is not None and num_q_heads % num_devices:
        raise ShardingError(
            f"cannot shard num_q_heads={num_q_heads} across "
            f"tp={num_devices} devices: query heads are split in whole "
            f"GQA groups (num_q_heads % tp must be 0)"
        )
    return num_kv_heads // num_devices


def make_kv_cache_specs(num_layers: int, num_kv_heads: int, num_pools: int,
                        pages_per_pool: int, page_size: int, k_dim: int,
                        v_dim: int, dtype: torch.dtype) \
        -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{'k_pages', 'v_pages'}: (shape, dtype) of
    [L, Hkv, num_pools, pages_per_pool, page_size, k_dim / v_dim]; v_dim 0
    means V is a view into the K rows (MLA's latent) and only 'k_pages'
    is listed, as the reference's `make_kv_cache_specs`."""
    lead = (num_layers, num_kv_heads, num_pools, pages_per_pool, page_size)
    specs = {"k_pages": (lead + (k_dim,), dtype)}
    if v_dim:
        specs["v_pages"] = (lead + (v_dim,), dtype)
    return specs


def shard_cache_specs(specs: dict, num_devices: int) -> dict:
    """Per-rank view of `make_kv_cache_specs`: the head axis (dim 1) is
    divided across the ranks, everything else is replicated."""
    out = {}
    for name, (shape, dtype) in specs.items():
        local = local_kv_heads(shape[1], num_devices)
        out[name] = (shape[:1] + (local,) + tuple(shape[2:]), dtype)
    return out


def make_kv_cache(num_layers: int, num_kv_heads: int, num_pools: int,
                  pages_per_pool: int, page_size: int, k_dim: int,
                  v_dim: int, dtype: torch.dtype, device,
                  num_devices: int = 1) -> dict[str, torch.Tensor]:
    """Zeroed tensors of `make_kv_cache_specs`; with `num_devices` > 1
    one rank's pool (`shard_cache_specs`), allocated at that size."""
    specs = shard_cache_specs(
        make_kv_cache_specs(num_layers, num_kv_heads, num_pools,
                            pages_per_pool, page_size, k_dim, v_dim, dtype),
        num_devices)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in specs.items()}


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
