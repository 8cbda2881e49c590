"""Automatic prefix caching: content-addressed KV page reuse (vLLM analog).

Design
======
The paged KV cache already stores every sequence's keys/values in
position-independent pages behind a per-sequence page table, so two
sequences that share a token prefix can — physically — point their leading
page-table entries at the *same* pages.  This module adds the bookkeeping
that makes that sharing automatic and safe:

Content addressing (hash-chained page keys)
    A full page of `page_size` tokens is identified by

        key(i) = sha256(key(i-1) || token_ids[i*ps : (i+1)*ps])

    i.e. each key commits to the page's tokens AND its entire prefix via
    the parent digest, so equal keys <=> equal token prefixes (up to hash
    collision; sha256 makes that a non-concern).  Only FULL pages are
    indexed: a partially filled page's content still changes as tokens
    arrive, and sharing it would require copy-on-write.

Lifecycle (with `RefCountedPageAllocator`)
    * insert: after a prefill (and again when a request finishes or is
      preempted — donation), every full page of the now-written token
      stream is registered under its chain key and `mark_cached` on the
      allocator.  First writer wins: if a key is already mapped, the new
      physical copy simply stays uncached and is freed normally.
    * match: admission walks the chain from the root and returns the
      longest run of indexed pages.  Matched pages may be live (shared
      with running sequences; refcount bumped) or parked in the
      allocator's evictable LRU pool (resurrected by `reuse`).
    * evict: when the free list runs dry the allocator reclaims evictable
      pages LRU-first and calls back into `_on_evict`, which drops the
      hash entry — a stale key can never outlive its page's content.

Safety argument
    A request with `num_cached_tokens = k * page_size` cached tokens only
    ever WRITES key/value rows at positions >= num_cached_tokens, which by
    page arithmetic land in its freshly allocated tail pages — shared
    pages are read-only by construction, so no copy-on-write is needed.
    The scheduler additionally caps matches at
    `(num_prompt_tokens - 1) // page_size` pages so at least one prompt
    token is always prefilled (the model needs last-token logits).

Stats: `hits` / `misses` count admission-time lookups (a hit = nonzero
cached prefix), `hit_tokens` the tokens skipped; evictions live on the
allocator and are merged into `stats()`.
"""
from __future__ import annotations

import hashlib
from typing import Iterator, Sequence

from repro_torch.core.paged.allocator import RefCountedPageAllocator

_ROOT = b"prefix-cache-root"


def _page_key(parent: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.sha256(parent)
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.digest()


def chain_keys(tokens: Sequence[int], page_size: int) -> Iterator[bytes]:
    """Yield the hash-chain key of every FULL page covered by `tokens`."""
    digest = _ROOT
    for lo in range(0, (len(tokens) // page_size) * page_size, page_size):
        digest = _page_key(digest, tokens[lo: lo + page_size])
        yield digest


class PrefixCache:
    """Content-addressed index: page-chain key -> physical page id."""

    def __init__(self, alloc: RefCountedPageAllocator, page_size: int,
                 telemetry=None):
        self.alloc = alloc
        self.page_size = page_size
        self.telemetry = telemetry  # obs.Telemetry | None
        self._page_of: dict[bytes, int] = {}  # chain key -> page id
        self._key_of: dict[int, bytes] = {}   # page id   -> chain key
        alloc.on_evict = self._on_evict
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self._page_of)

    # -- allocator callback ------------------------------------------------

    def _on_evict(self, page: int) -> None:
        key = self._key_of.pop(page, None)
        if key is not None:
            del self._page_of[key]
        if self.telemetry is not None:
            self.telemetry.cache_event("eviction")

    # -- queries -----------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> list[int]:
        """Longest indexed page chain for `tokens`, as physical page ids.
        Read-only: does not touch refcounts, LRU order, or counters."""
        pages: list[int] = []
        for key in chain_keys(tokens, self.page_size):
            page = self._page_of.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def record(self, num_cached_tokens: int) -> None:
        """Admission-time accounting for one scheduled request."""
        if num_cached_tokens > 0:
            self.hits += 1
            self.hit_tokens += num_cached_tokens
        else:
            self.misses += 1
        if self.telemetry is not None:
            self.telemetry.cache_event(
                "hit" if num_cached_tokens > 0 else "miss",
                tokens=num_cached_tokens)

    # -- registration ------------------------------------------------------

    def _index(self, key: bytes, page: int) -> int:
        """Register one (chain key -> page) binding; first writer wins."""
        if key in self._page_of:
            return 0  # chain position already backed by another page
        if page in self._key_of:
            # page already indexed (shared prefix re-donated): its key
            # must agree with the chain — content never changes.
            assert self._key_of[page] == key, "cached page content drift"
            return 0
        self._page_of[key] = page
        self._key_of[page] = key
        self.alloc.mark_cached(page)
        return 1

    def _insert_pages(self, tokens, pages, start: int, n_full: int,
                      digest: bytes) -> tuple[tuple[int, bytes], int]:
        """Shared indexing walk over full pages [start, n_full), chaining
        from `digest` (the key of page start-1).  Returns the advanced
        (next_page_idx, digest) cursor and the #pages newly indexed."""
        ps = self.page_size
        added = 0
        for i in range(start, n_full):
            digest = _page_key(digest, tokens[i * ps: (i + 1) * ps])
            added += self._index(digest, pages[i])
        return (max(start, n_full), digest), added

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               num_tokens: int) -> int:
        """Index every full page among the first `num_tokens` tokens (whose
        KV rows are actually written). `pages[i]` must hold tokens
        [i*ps, (i+1)*ps). First writer wins on key collisions: a duplicate
        physical copy stays uncached. Returns #pages newly indexed."""
        n_full = min(num_tokens, len(tokens)) // self.page_size
        _, added = self._insert_pages(tokens, pages, 0, n_full, _ROOT)
        return added

    def insert_incremental(self, tokens: Sequence[int],
                           pages: Sequence[int], num_tokens: int,
                           cursor: tuple[int, bytes] | None = None,
                           ) -> tuple[int, bytes]:
        """`insert`, resumable across a chunked prefill: `cursor` is
        (next_page_idx, parent_digest) from the previous call, so each
        full page is hashed exactly ONCE over the whole prefill instead
        of re-walking the chain from token 0 after every chunk.  Returns
        the advanced cursor."""
        start, digest = cursor if cursor is not None else (0, _ROOT)
        n_full = min(num_tokens, len(tokens)) // self.page_size
        new_cursor, _ = self._insert_pages(tokens, pages, start, n_full,
                                           digest)
        return new_cursor

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "cache_hit_tokens": self.hit_tokens,
            "cache_evictions": self.alloc.evictions,
            "cache_pages": len(self._page_of),
            "cache_evictable_pages": self.alloc.evictable_pages,
        }
