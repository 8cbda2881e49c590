"""Host-side KV page allocators (the vLLM block-manager analog).

Page 0 is the NULL page — never allocated, used as the target of padded
block-table entries so every lowered program stays fully static (paper C5).
Pure numpy/python: allocation decisions are host-side scheduler work and
never enter the compiled graphs (paper §6.1 metadata discipline).

Two allocators:

`PageAllocator`
    exclusive ownership: every page is either free or held by exactly one
    sequence.  A proper allocated-set invariant makes double frees and
    foreign frees hard errors (not a best-effort tail scan).

`RefCountedPageAllocator`
    the prefix-caching allocator.  Pages carry reference counts so a full
    page can back several sequences at once (shared prompt prefixes), and
    pages whose refcount drops to zero while still *content-addressed* by
    the prefix cache are parked in an LRU "evictable" pool instead of the
    free list.  `allocate()` transparently reclaims LRU evictable pages
    when the free list runs dry, notifying the prefix cache through the
    `on_evict` hook so stale hash entries never outlive their page.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable


class OutOfPages(Exception):
    pass


class PageAllocator:
    """Exclusive-ownership page pool over page ids [1, num_pages)."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))  # LIFO; page 0 = NULL
        self._allocated: set[int] = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def pages_to_cover(self, num_held: int, num_tokens: int) -> int:
        """Additional pages a sequence currently holding `num_held` pages
        needs so its table covers `num_tokens` tokens.  Chunk-granular
        growth: prefill chunks and decode steps both extend a sequence's
        page run incrementally instead of reserving the full prompt's
        pages up-front."""
        return max(0, self.pages_needed(num_tokens) - num_held)

    def fits_pool(self, num_tokens: int) -> bool:
        """Whether `num_tokens` can EVER be resident (pool capacity, not
        current free count) — the admission sanity check that keeps a
        chunked prefill from being admitted, partially computed, and then
        preempt-thrashed forever because its prompt exceeds the pool."""
        return self.pages_needed(num_tokens) <= self.num_pages - 1

    def can_allocate(self, n: int) -> bool:
        return n <= self.free_pages

    def allocate(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, pages: list[int]) -> None:
        for p in pages:
            assert 0 < p < self.num_pages, p
            assert p in self._allocated, f"double free of page {p}"
            self._allocated.remove(p)
            self._free.append(p)

    def check_invariants(self, allocated: list[list[int]]) -> None:
        """Test hook: free + allocated must partition [1, num_pages)."""
        flat = [p for group in allocated for p in group]
        assert len(set(flat)) == len(flat), "page double-booked"
        assert set(flat) == self._allocated, "allocated set out of sync"
        assert set(flat).isdisjoint(self._free), "allocated page in free list"
        assert len(flat) + len(self._free) == self.num_pages - 1

    def stats(self) -> dict:
        """Pool-occupancy snapshot (`free_pages` here is TRULY free pages,
        unlike the `free_pages` property on the ref-counted subclass which
        reports allocatable capacity incl. evictable pages).  Keys are
        uniform across both allocators so Engine.step() stats and the
        telemetry pool gauges need no isinstance branching."""
        return {
            "free_pages": len(self._free),
            "referenced_pages": len(self._allocated),
            "evictable_pages": 0,
            "shared_pages": 0,
            "cached_pages": 0,
            "total_refs": len(self._allocated),
            "evictions": 0,
        }

    def device_stats(self, device: int) -> dict:
        """Per-device pool view under head-axis tensor parallelism: every
        device holds the SAME page occupancy (only the KV head slice
        differs), so each view is this host allocator's snapshot tagged
        with its device index.  A future expert/data-parallel split with
        genuinely divergent per-device occupancy overrides this."""
        s = self.stats()
        s["device"] = device
        return s

    def mesh_stats(self, num_devices: int = 1) -> dict:
        """Aggregate pool snapshot across the mesh: every stat key summed
        over the per-device views (at num_devices=1 the values equal
        `stats()` exactly), plus `num_devices` and the `per_device` list
        so invariants can be checked per device AND in aggregate."""
        per = [self.device_stats(d) for d in range(num_devices)]
        agg = {k: sum(d[k] for d in per) for k in per[0] if k != "device"}
        agg["num_devices"] = num_devices
        agg["per_device"] = per
        return agg


class RefCountedPageAllocator(PageAllocator):
    """Ref-counted pool with an LRU pool of cached-but-unreferenced pages.

    State partition of [1, num_pages):
      * referenced : refcount >= 1 (held by >= 1 sequence)
      * evictable  : refcount == 0 but content still indexed by the prefix
                     cache (LRU-ordered; reclaimable on demand)
      * free       : unreferenced, content dead

    Without a prefix cache attached (nothing ever `mark_cached`), behavior
    is identical to `PageAllocator` with refcounts pinned at 1.

    Eviction order is hit-count-weighted (radix-cache style): each prefix
    cache hit (`reuse`) bumps the page's hit counter, and `_evict_one`
    reclaims the evictable page with the FEWEST hits, breaking ties by
    LRU order.  A pool where nothing was ever re-hit degenerates to pure
    LRU, so cache-off workloads see the old behavior exactly.
    """

    def __init__(self, num_pages: int, page_size: int):
        super().__init__(num_pages, page_size)
        self._ref: dict[int, int] = {}
        self._evictable: OrderedDict[int, None] = OrderedDict()  # LRU->MRU
        self._cached: set[int] = set()
        self._hits: dict[int, int] = {}  # page -> prefix-cache hit count
        self.on_evict: Callable[[int], None] | None = None
        self.evictions = 0

    # -- capacity ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Allocatable capacity: truly free + reclaimable evictable pages."""
        return len(self._free) + len(self._evictable)

    @property
    def evictable_pages(self) -> int:
        return len(self._evictable)

    def ref_count(self, page: int) -> int:
        return self._ref.get(page, 0)

    # -- allocate / free ---------------------------------------------------

    def allocate(self, n: int) -> list[int]:
        if n > self.free_pages:
            raise OutOfPages(f"need {n}, have {self.free_pages}")
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p = self._evict_one()
            self._allocated.add(p)
            self._ref[p] = 1
            out.append(p)
        return out

    def _evict_one(self) -> int:
        # fewest hits first; ties fall back to LRU (iteration order of the
        # OrderedDict is LRU->MRU, and min() keeps the first minimum)
        page = min(self._evictable, key=lambda p: self._hits.get(p, 0))
        del self._evictable[page]
        self._cached.discard(page)
        self._hits.pop(page, None)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(page)
        return page

    def incref(self, pages: list[int]) -> None:
        for p in pages:
            assert p in self._ref, f"incref of unreferenced page {p}"
            self._ref[p] += 1

    def reuse(self, pages: list[int]) -> None:
        """Pin cached pages for a new sequence: bump live refs, resurrect
        evictable pages (removing them from the LRU pool)."""
        for p in pages:
            self._hits[p] = self._hits.get(p, 0) + 1
            if p in self._ref:
                self._ref[p] += 1
            else:
                assert p in self._evictable, f"reuse of dead page {p}"
                del self._evictable[p]
                self._allocated.add(p)
                self._ref[p] = 1

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page. A page reaching refcount 0 goes to
        the evictable LRU pool if the prefix cache indexes it, else to the
        free list."""
        for p in pages:
            assert 0 < p < self.num_pages, p
            assert p in self._ref, f"double free of page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._allocated.remove(p)
                if p in self._cached:
                    self._evictable[p] = None  # append at MRU end
                else:
                    self._hits.pop(p, None)  # content dead
                    self._free.append(p)

    # -- prefix-cache hooks ------------------------------------------------

    def mark_cached(self, page: int) -> None:
        """The prefix cache now content-addresses this page: when its last
        reference drops it becomes evictable instead of free."""
        assert 0 < page < self.num_pages, page
        self._cached.add(page)

    def uncache(self, page: int) -> None:
        """Drop the cache marking (cache-side invalidation). An evictable
        page moves straight to the free list."""
        self._cached.discard(page)
        self._hits.pop(page, None)
        if page in self._evictable:
            del self._evictable[page]
            self._free.append(page)

    # -- invariants --------------------------------------------------------

    def check_invariants(self, allocated: list[list[int]]) -> None:
        """`allocated` holds one page list PER SEQUENCE; shared pages appear
        in several lists. Refcounts must equal the multiplicity, and
        referenced/evictable/free must partition [1, num_pages)."""
        counts: dict[int, int] = {}
        for group in allocated:
            assert len(set(group)) == len(group), "page double-booked in seq"
            for p in group:
                counts[p] = counts.get(p, 0) + 1
        assert counts == self._ref, (
            f"refcount mismatch: held={counts} ref={self._ref}")
        assert set(self._ref) == self._allocated
        ref = set(self._ref)
        evict = set(self._evictable)
        free = set(self._free)
        assert ref.isdisjoint(evict) and ref.isdisjoint(free) \
            and evict.isdisjoint(free), "page in two pools"
        assert len(ref) + len(evict) + len(free) == self.num_pages - 1
        assert evict <= self._cached, "evictable page not cache-indexed"

    def stats(self) -> dict:
        return {
            "free_pages": len(self._free),
            "referenced_pages": len(self._ref),
            "evictable_pages": len(self._evictable),
            "shared_pages": sum(1 for c in self._ref.values() if c > 1),
            "cached_pages": len(self._cached),
            "total_refs": sum(self._ref.values()),
            "evictions": self.evictions,
        }
