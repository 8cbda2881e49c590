"""N-gram draft proposals for speculative decoding (prompt-lookup style).

A copy of `repro.serving.draft` (pure Python: the port imports nothing
of the JAX package, so it keeps its own).

No second model: each request carries an incrementally-built suffix table
over its own token history (prompt + accepted output).  When the last
``n`` tokens have occurred before, the tokens that followed that earlier
occurrence are proposed as drafts.  The packed unified launch then
verifies all ``k`` drafts (plus the bonus token) in ONE dispatch — see
`repro_torch.serving.engine` for the launch contract and rollback
semantics.

Why n-gram lookup works: decode traffic is dominated by locally
repetitive text (code, templated prose, structured output, greedy
decode cycles of small models).  A suffix hit predicts the continuation
of an earlier occurrence; the verify step accepts the longest matching
prefix, so a wrong draft costs only the page it briefly held — outputs
are *exactly* those of sequential decoding by construction.

``DraftController`` adapts the per-step draft length ``k`` from an
accept-rate EMA so a stream that stops accepting stops paying for
speculation (the speculative-token dimension also feeds the autotuned
dispatch trees via ``BatchProfile.spec_tokens``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Knobs for the n-gram drafter + adaptive-k controller."""
    max_draft: int = 4      # upper bound on drafts per request per step
    min_ngram: int = 1      # shortest suffix length worth matching
    max_ngram: int = 3      # longest suffix length tried first
    # adaptive k: shrink while the accept-rate EMA sits below `low`,
    # regrow toward max_draft while it sits above `high`
    adaptive: bool = True
    ema_alpha: float = 0.2
    low: float = 0.3
    high: float = 0.6

    def __post_init__(self):
        assert self.max_draft >= 1 and 1 <= self.min_ngram <= self.max_ngram


class NGramTable:
    """Per-request suffix index: n-gram -> position right after its last
    occurrence.  Built incrementally — `extend` indexes only new tokens,
    `propose` is a handful of dict probes."""

    def __init__(self, min_ngram: int, max_ngram: int):
        self.min_ngram = min_ngram
        self.max_ngram = max_ngram
        self.tokens: list[int] = []
        # continuation position AFTER the most recent occurrence, keyed by
        # the n-gram tuple, one dict per n.  The current suffix is always
        # its own most recent occurrence (extend indexes it as it lands),
        # so `_prev` keeps the SECOND most recent — that earlier
        # occurrence is what propose predicts the continuation from.
        self._next: dict[int, dict[tuple, int]] = {
            n: {} for n in range(min_ngram, max_ngram + 1)}
        self._prev: dict[int, dict[tuple, int]] = {
            n: {} for n in range(min_ngram, max_ngram + 1)}

    def __len__(self) -> int:
        return len(self.tokens)

    def extend(self, new_tokens: list[int]) -> None:
        toks = self.tokens
        start = len(toks)
        toks.extend(new_tokens)
        for end in range(start + 1, len(toks) + 1):
            for n in range(self.min_ngram, self.max_ngram + 1):
                if end >= n:
                    gram = tuple(toks[end - n:end])
                    old = self._next[n].get(gram)
                    if old is not None:
                        self._prev[n][gram] = old
                    self._next[n][gram] = end

    def propose(self, k: int) -> list[int]:
        """Longest-suffix match: drafts are the tokens that followed the
        most recent earlier occurrence of the current suffix.  When the
        matched continuation runs off the end of the history (constant or
        cyclic tails), the lookup CHAINS over the virtual sequence
        ``history + draft-so-far`` until ``k`` tokens or no match."""
        toks = self.tokens
        if k <= 0 or len(toks) < self.min_ngram:
            return []
        virt = toks
        draft: list[int] = []
        while len(draft) < k:
            got = None
            for n in range(min(self.max_ngram, len(virt)),
                           self.min_ngram - 1, -1):
                gram = tuple(virt[-n:])
                pos = self._next[n].get(gram)
                if pos == len(toks):  # match ends the history: no follower
                    pos = self._prev[n].get(gram)
                if pos is not None and pos < len(toks):
                    got = toks[pos:pos + k - len(draft)]
                    break
            if not got:
                break
            if not draft:
                virt = list(toks)  # copy-on-extend
            draft.extend(got)
            virt.extend(got)
        return draft


class DraftController:
    """Chooses k per step from an accept-rate EMA over verify outcomes."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.k = cfg.max_draft
        self.ema: float | None = None
        self.proposed = 0
        self.accepted = 0

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def observe(self, proposed: int, accepted: int) -> None:
        if proposed <= 0:
            return
        self.proposed += proposed
        self.accepted += accepted
        rate = accepted / proposed
        a = self.cfg.ema_alpha
        self.ema = rate if self.ema is None else (1 - a) * self.ema + a * rate
        if not self.cfg.adaptive:
            return
        if self.ema < self.cfg.low:
            self.k = max(1, self.k - 1)
        elif self.ema > self.cfg.high:
            self.k = min(self.cfg.max_draft, self.k + 1)


class Drafter:
    """Engine-side facade: per-request tables + the shared controller.

    Tables key on ``req_id`` and survive preemption for free — preemption
    folds ``output`` into ``prompt``, so the concatenated token history the
    table indexes is unchanged and the incremental cursor just continues.
    """

    def __init__(self, cfg: SpecConfig | None = None):
        self.cfg = cfg or SpecConfig()
        self.controller = DraftController(self.cfg)
        self._tables: dict[int, NGramTable] = {}

    def propose(self, req) -> list[int]:
        """Drafts for this step (possibly []), capped by the controller's
        current k and by the request's remaining token budget."""
        k = self.controller.k
        # no point drafting past max_new_tokens: the verify step emits at
        # most (drafts accepted + 1) tokens and truncates at the budget
        k = min(k, req.max_new_tokens - len(req.output) - 1)
        if k <= 0:
            return []
        table = self._tables.get(req.req_id)
        if table is None:
            table = self._tables[req.req_id] = NGramTable(
                self.cfg.min_ngram, self.cfg.max_ngram)
        history_len = len(req.prompt) + len(req.output)
        if len(table) > history_len:  # cannot happen in-engine; be safe
            self._tables[req.req_id] = table = NGramTable(
                self.cfg.min_ngram, self.cfg.max_ngram)
        if len(table) < history_len:
            combined = req.prompt + req.output
            table.extend(combined[len(table):])
        return table.propose(k)

    def observe(self, proposed: int, accepted: int) -> None:
        self.controller.observe(proposed, accepted)

    def forget(self, req_id: int) -> None:
        self._tables.pop(req_id, None)
