"""Continuous-batching scheduler (vLLM-v1 analog, paper §3/§6.1).

Policy per step (decode-priority, matching vLLM's behavior that the paper's
Fig. 6c/6d analysis leans on):
  1. every RUNNING request decodes one token; if it crosses a page boundary
     it needs one new page — if the pool is exhausted, preempt the youngest
     running request (free its pages, requeue) until the rest fit;
  2. in-flight chunked prefills (PREFILLING) schedule their next chunk
     against the remaining token budget, growing pages chunk-granularly;
  3. admit WAITING requests into free slots while (a) a batch slot is free,
     (b) their first chunk's pages fit, (c) the token budget holds — a
     request is never admitted with an empty (0-token) first chunk.

Chunked prefill (`enable_chunked_prefill=True`): a prompt longer than the
per-step token budget is split into budget-sized chunks scheduled across
consecutive steps.  The request sits in the batch in the PREFILLING state
with `num_computed_tokens` tracking progress; each chunk resumes attention
at `context = num_computed_tokens` through the engine's cached-context
prefill path.  The budget is a TOTAL per-step token budget: scheduled
decodes charge one token each and partial prefills fill the remainder, so
a long prompt is absorbed across steps without ever displacing decodes —
the inter-token-latency protection the paper's serving trajectory leans
on.  Without chunking, a prompt only ever schedules whole (admission
blocks while it exceeds the budget) and decodes are not charged.

Cache-aware admission (prefix caching enabled): each candidate's longest
cached prefix is looked up in the `PrefixCache`; the matched full pages are
pinned (ref-count bump / LRU resurrection) and only the uncached tail is
allocated, and the budget is charged for the UNCACHED tokens only.  A
cache hit composes with chunking as "a first chunk that starts at
context = matched_len" — both land on the same resumable-prefill path.
On finish/preemption, full written pages are donated back to the cache
(they become evictable, not free), so multi-turn, preempt-resume, and
chunk-resume traffic re-admits nearly for free.  Admission is also
prefix-AWARE in ordering: the waiting queue (head pinned, so misses are
delayed but never starved) is stable-sorted by cached-prefix length each
step, so once one request of a shared-prefix group has prefilled (and the
engine has indexed its pages), the rest of the group is admitted together
in the next step and hits the cache — instead of interleaving with
unrelated misses and re-prefilling the prefix.

Outputs host-side ScheduleDecision objects; all array metadata is built by
the engine (paper §6.1 'computation of metadata').
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.paged.allocator import PageAllocator
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request, State


@dataclasses.dataclass
class ScheduleDecision:
    decode_reqs: list[Request]
    prefill_reqs: list[Request]  # admissions + continued chunks, each with
    #                              (chunk_start, num_scheduled_tokens) set
    preempted: list[Request]
    token_budget: int = 0  # the step's total budget (max_prefill_tokens)
    decodes_charged: bool = False  # chunked mode charges decodes 1 token
    spec_tokens: int = 0  # draft tokens proposed this step (speculative)

    @property
    def scheduled_prefill_tokens(self) -> int:
        return sum(r.num_scheduled_tokens for r in self.prefill_reqs)

    @property
    def budget_utilization(self) -> float:
        """Fraction of the per-step token budget actually scheduled —
        the observable the chunk-size autotuner (cost-model roofline ->
        max_prefill_tokens) is validated against: a well-sized budget
        saturates during prefill bursts without starving decodes.  Can
        exceed 1.0 in chunked mode: decodes are never displaced, so a
        step holding more decodes than the budget is decode-saturated
        (prefill contributes zero), not over-scheduled."""
        used = self.scheduled_prefill_tokens
        if self.decodes_charged:
            used += len(self.decode_reqs)
        return used / self.token_budget if self.token_budget else 0.0


class Scheduler:
    def __init__(self, allocator: PageAllocator, *, max_seqs: int,
                 max_prefill_tokens: int = 8192,
                 prefix_cache: PrefixCache | None = None,
                 enable_chunked_prefill: bool = False,
                 telemetry=None, drafter=None):
        assert max_prefill_tokens > 0, "token budget must be positive"
        self.alloc = allocator
        self.max_seqs = max_seqs
        self.max_prefill_tokens = max_prefill_tokens
        self.prefix_cache = prefix_cache
        self.enable_chunked_prefill = enable_chunked_prefill
        self.telemetry = telemetry  # obs.Telemetry | None
        self.drafter = drafter  # serving.draft.Drafter | None (spec decode)
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        # streaming finish callback: invoked with each request the moment
        # it leaves the batch FINISHED (normal finish or admission-time
        # rejection) — the engine's submit()/stream() API hangs its
        # per-request completion events off this
        self.on_finish = None
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        # per-step memo of _order_waiting's match results, reused by the
        # admit loop: (evictions watermark, {req_id: matched pages})
        self._match_memo: tuple[int, dict] | None = None

    def add(self, req: Request) -> None:
        # a request whose final length can never be resident (pool
        # CAPACITY, not transient pressure) would wait forever and
        # head-of-line block the queue: reject at submission
        assert self.alloc.fits_pool(
            req.num_prompt_tokens + req.max_new_tokens), (
            f"request needs "
            f"{self.alloc.pages_needed(req.num_prompt_tokens + req.max_new_tokens)}"
            f" pages, pool holds {self.alloc.num_pages - 1}")
        self.waiting.append(req)
        if self.telemetry is not None:
            self.telemetry.requests.submit(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _free_request(self, req: Request) -> None:
        if self.prefix_cache is not None and req.context_len > 0:
            # donate: index the full written pages before releasing them,
            # so they land in the evictable pool instead of the free list.
            # The cursor resumes past the prompt pages the engine already
            # indexed — only decode-written pages hash here.
            tokens = req.prompt + req.output
            req.cache_cursor = self.prefix_cache.insert_incremental(
                tokens, req.pages, min(req.context_len, len(tokens)),
                req.cache_cursor)
        self.alloc.free(req.pages)
        req.pages = []
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None

    def finish(self, req: Request) -> None:
        req.state = State.FINISHED
        self._free_request(req)
        self.running.remove(req)
        if self.drafter is not None:
            self.drafter.forget(req.req_id)
        if self.telemetry is not None:
            self.telemetry.scheduler_event("finished")
            self.telemetry.requests.finish(req)
        if self.on_finish is not None:
            self.on_finish(req)

    def _preempt(self, req: Request) -> None:
        """Evict `req` from the batch back to the head of the wait queue.
        Written pages are donated to the prefix cache first (when enabled),
        so the re-admission resumes from the donated prefix instead of
        recomputing it.  Works mid-prefill: only `context_len` tokens (the
        executed chunks) have KV, and only those are donated."""
        req.state = State.PREEMPTED
        # async loop: drop the in-flight placeholder token (its value
        # never reached the host) and bump the speculative epoch so the
        # engine discards this request's rows from in-flight launches.
        # num_generated is NOT reset: the regenerated token reuses the
        # same RNG stream position, so sampling survives eviction.
        req.discard_speculative()
        self._free_request(req)  # donates written pages while the
        req.prompt = req.prompt + req.output  # token ids still
        req.output = []                       # match the layout
        req.context_len = 0
        req.num_cached_tokens = 0
        req.num_computed_tokens = 0
        req.chunk_start = 0
        req.num_scheduled_tokens = 0
        req.cache_cursor = None
        self.running.remove(req)
        self.waiting.insert(0, req)
        if self.telemetry is not None:
            self.telemetry.scheduler_event("preempted")
            self.telemetry.requests.preempt(req)

    def _preempt_one(self) -> Request | None:
        if not self.running:
            return None
        victim = max(self.running, key=lambda r: r.arrival_step)
        self._preempt(victim)
        return victim

    def _match_prefix(self, req: Request) -> list[int]:
        """Longest cached page chain for the prompt, capped so at least one
        token is always prefilled (last-token logits must be computed)."""
        if self.prefix_cache is None:
            return []
        pages = self.prefix_cache.match(req.prompt)
        max_full = (req.num_prompt_tokens - 1) // self.alloc.page_size
        return pages[:max_full]

    def _order_waiting(self) -> None:
        """Prefix-aware admission ordering: stable-sort the waiting queue
        by descending cached-prefix length so requests sharing a cached
        prefix are admitted in the same step.  The engine indexes a
        prefill's written pages the step they are computed, so once the
        FIRST request of a shared-prefix group lands its pages in the
        cache, the whole group jumps ahead of unrelated misses and is
        admitted together — every member but the first admits nearly for
        free (only uncached tokens charge the budget).

        Fairness: the queue HEAD is pinned — the oldest waiting request
        (or a just-preempted one, re-queued at position 0) keeps absolute
        admission priority, so a sustained stream of cache-hit arrivals
        can delay a miss by at most the queue ahead of it, never starve
        it.  Stability keeps FIFO among equal matches.  Cost per step is
        O(matched_pages + 1) hashes per waiting request (`match` walks
        the chain lazily and stops at the first miss), and the sort is
        skipped entirely on steps that cannot admit."""
        if self.prefix_cache is None or len(self.waiting) < 3:
            return
        head, rest = self.waiting[0], self.waiting[1:]
        matched = {r.req_id: self._match_prefix(r) for r in rest}
        rest.sort(key=lambda r: -len(matched[r.req_id]))
        self.waiting[:] = [head] + rest
        # hand the walked chains to the admit loop so it does not re-hash
        # them; keyed to the eviction counter — an allocation-triggered
        # eviction mid-admission invalidates every memoized match (the
        # pages may be gone), falling back to a fresh walk
        self._match_memo = (self.alloc.evictions, matched)

    def _memoized_match(self, req: Request) -> list[int]:
        memo = self._match_memo
        if memo is not None and memo[0] == self.alloc.evictions:
            pages = memo[1].get(req.req_id)
            if pages is not None:
                return pages
        return self._match_prefix(req)

    def _schedule_chunk(self, req: Request, chunk: int) -> None:
        """Plan `chunk` prompt tokens starting at the request's progress
        mark.  The engine executes the chunk this step; a request whose
        plan reaches the end of the prompt samples its first token and
        transitions to RUNNING, otherwise it stays PREFILLING."""
        assert chunk > 0, "never schedule an empty chunk"
        req.chunk_start = req.num_computed_tokens
        req.num_scheduled_tokens = chunk
        req.num_computed_tokens += chunk
        req.state = (State.RUNNING if req.prefill_done
                     else State.PREFILLING)

    def step(self, step_idx: int) -> ScheduleDecision:
        preempted: list[Request] = []
        budget = self.max_prefill_tokens
        self._match_memo = None  # stale across steps: donations add pages

        # --- 1. decode pass: grow pages, preempting if needed -------------
        decode_reqs: list[Request] = []
        for req in list(self.running):
            if req.state is not State.RUNNING:
                continue  # PREFILLING: chunk continuation happens in pass 2
            if req.done:
                # only reachable in the async double-buffered loop: the
                # request's last token is still in flight (a placeholder
                # holds its output position) but max_new_tokens is already
                # reached, so it will finish as soon as the token lands —
                # scheduling a speculative decode for it would be wasted
                continue
            need = self.alloc.pages_to_cover(len(req.pages), req.total_len + 1)
            while need > self.alloc.free_pages:
                victim = self._preempt_one()
                if victim is None:
                    break
                preempted.append(victim)
                if victim in decode_reqs:
                    decode_reqs.remove(victim)
                if victim is req:
                    break
            if req.state is not State.RUNNING:
                continue  # got preempted itself
            if need > 0:
                req.pages.extend(self.alloc.allocate(need))
            decode_reqs.append(req)
        if self.enable_chunked_prefill:
            # decodes share the per-step token budget with prefill chunks
            budget -= len(decode_reqs)

        # --- 2. continue in-flight chunked prefills -----------------------
        # A continuation NEVER preempts (decodes keep absolute priority and
        # prefill-vs-prefill eviction livelocks): under page pressure the
        # chunk shrinks to what the free pool covers right now, down to a
        # stall — decodes and finishes free pages within a few steps.
        prefill_reqs: list[Request] = []
        ps = self.alloc.page_size
        for req in [r for r in self.running if r.state is State.PREFILLING]:
            if budget <= 0:
                break
            chunk = min(req.remaining_prompt_tokens, budget)
            coverable = ((len(req.pages) + self.alloc.free_pages) * ps
                         - req.num_computed_tokens)
            chunk = min(chunk, coverable)
            if chunk <= 0:
                if self.telemetry is not None:
                    self.telemetry.scheduler_event("stalled")
                continue  # stalled: no empty chunks, wait for free pages
            need = self.alloc.pages_to_cover(
                len(req.pages), req.num_computed_tokens + chunk)
            if need > 0:
                req.pages.extend(self.alloc.allocate(need))
            self._schedule_chunk(req, chunk)
            budget -= chunk
            prefill_reqs.append(req)

        # --- 3. admit prefills --------------------------------------------
        if self._free_slots and budget > 0:
            self._order_waiting()
        while self.waiting and self._free_slots and budget > 0:
            req = self.waiting[0]
            if not self.alloc.fits_pool(req.num_prompt_tokens
                                        + req.max_new_tokens):
                # only reachable after preemption folded generated tokens
                # into the prompt (add() rejects oversize submissions):
                # the request can never again be resident, so finish it
                # with what it produced instead of blocking the queue
                self.waiting.pop(0)
                req.state = State.FINISHED
                if self.telemetry is not None:
                    self.telemetry.scheduler_event("rejected")
                    self.telemetry.requests.finish(req)
                if self.on_finish is not None:
                    self.on_finish(req)
                continue
            cached_pages = self._memoized_match(req)
            num_cached = len(cached_pages) * self.alloc.page_size
            remaining = req.num_prompt_tokens - num_cached
            if self.enable_chunked_prefill:
                chunk = min(remaining, budget)
            else:
                if remaining > budget:
                    break
                chunk = remaining
            if chunk <= 0:
                break  # exhausted budget: never admit an empty first chunk
            n_new = (self.alloc.pages_needed(num_cached + chunk)
                     - len(cached_pages))
            if cached_pages:
                # pin BEFORE allocating: allocation may evict LRU pages,
                # and the match must not be reclaimed out from under us.
                self.alloc.reuse(cached_pages)
            if not self.alloc.can_allocate(n_new):
                if cached_pages:
                    self.alloc.free(cached_pages)  # unpin
                break
            if self.prefix_cache is not None:
                self.prefix_cache.record(num_cached)
            self.waiting.pop(0)
            req.pages = cached_pages + self.alloc.allocate(n_new)
            req.num_cached_tokens = num_cached
            req.num_computed_tokens = num_cached
            req.slot = self._free_slots.pop()
            req.arrival_step = step_idx
            req.context_len = num_cached
            self._schedule_chunk(req, chunk)
            budget -= chunk
            self.running.append(req)
            prefill_reqs.append(req)
            if self.telemetry is not None:
                self.telemetry.scheduler_event("admitted")

        # --- 4. speculative drafts (spec-decode engines only) -------------
        # Runs AFTER admissions so the chunk-region row count is final: a
        # drafted decode row packs as a resumed chunk (q = k+1) and shares
        # the [max_seqs, 2*max_seqs) row range with prefill chunks.
        # Speculation is strictly best-effort: it never preempts and never
        # evicts cached pages — a draft shrinks to what the FREE pool
        # covers right now, down to nothing.  In chunked mode draft tokens
        # are charged to the budget after the fact (they ride the step,
        # they must not displace prefill admissions).
        spec_scheduled = 0
        if self.drafter is not None and decode_reqs:
            t0 = self.telemetry.clock.now() if self.telemetry else 0.0
            spec_slots = self.max_seqs - len(prefill_reqs)
            for req in decode_reqs:
                if spec_slots <= 0:
                    break
                drafts = self.drafter.propose(req)
                while drafts and self.alloc.pages_to_cover(
                        len(req.pages),
                        req.total_len + len(drafts)) > self.alloc.free_pages:
                    drafts.pop()
                if not drafts:
                    continue
                need = self.alloc.pages_to_cover(
                    len(req.pages), req.total_len + len(drafts))
                if need > 0:
                    req.pages.extend(self.alloc.allocate(need))
                req.spec_tokens = drafts
                spec_scheduled += len(drafts)
                spec_slots -= 1
                if self.enable_chunked_prefill:
                    budget -= len(drafts)
            if self.telemetry is not None:
                self.telemetry.record_phase(
                    "draft", t0, self.telemetry.clock.now(),
                    tokens=spec_scheduled)

        # --- liveness backstop --------------------------------------------
        # Every resident request is a stalled chunked prefill (they jointly
        # exhausted the pool, so none can grow and nothing decodes): evict
        # the youngest so the oldest makes progress next step.  Requests
        # that are done except for an in-flight final token (the async
        # loop's done-skip above) are NOT stalled — they finish as soon as
        # the token lands, so they must not trip the backstop.
        if not decode_reqs and not prefill_reqs and any(
                not (r.prefill_done and r.done) for r in self.running):
            victim = self._preempt_one()
            if victim is not None:
                preempted.append(victim)

        return ScheduleDecision(decode_reqs, prefill_reqs, preempted,
                                token_budget=self.max_prefill_tokens,
                                decodes_charged=self.enable_chunked_prefill,
                                spec_tokens=spec_scheduled)
