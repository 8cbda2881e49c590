"""Request lifecycle objects for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Sequence

_ids = itertools.count()


class State(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"  # admitted, prompt only partially computed
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


PENDING_TOKEN = -1  # placeholder for an in-flight (not yet transferred)
#                     sampled token in the async double-buffered loop


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    eos_token: int | None = None
    temperature: float = 0.0  # 0 = greedy
    top_p: float = 1.0  # nucleus mass; 1.0 disables
    top_k: int = 0  # keep the k highest logits; 0 disables
    # sampling-stream id: the RNG stream is a pure function of
    # (engine seed, stream id, tokens generated), so two runs that pin the
    # same seed get bit-identical samples regardless of batch composition,
    # slot placement, or engine path.  None -> the req_id (fresh ids per
    # process, so cross-run reproducibility requires pinning).
    seed: int | None = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: State = State.WAITING
    output: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None  # batch slot while RUNNING/PREFILLING
    pages: list[int] = dataclasses.field(default_factory=list)
    context_len: int = 0  # tokens whose KV is actually written (engine-owned)
    num_cached_tokens: int = 0  # prefix tokens reused from the prefix cache
    # prefill progress (scheduler-owned plan): prompt tokens whose compute
    # has been scheduled — cached tokens count as computed.  A prefix-cache
    # hit and a chunk-resume are the same thing: a chunk starting at
    # context = num_computed_tokens > 0.
    num_computed_tokens: int = 0
    chunk_start: int = 0  # context at which this step's chunk begins
    num_scheduled_tokens: int = 0  # this step's chunk length
    # prefix-cache insert cursor (page idx, chain digest): lets the engine
    # index each written full page once across a chunked prefill
    cache_cursor: tuple | None = None
    arrival_step: int = 0
    # total tokens this request has sampled AND kept, across preemptions
    # (preemption folds output into prompt but does NOT reset this): the
    # per-token RNG counter, so a regenerated-after-preemption token draws
    # from the same stream position and reproducibility survives eviction
    num_generated: int = 0
    # async double-buffered loop bookkeeping (engine-owned): is the last
    # output element an un-transferred PENDING_TOKEN placeholder, and
    # which speculative-scheduling epoch do in-flight rows belong to
    # (preemption bumps the epoch so stale in-flight tokens are discarded)
    _placeholder: bool = False
    _spec_epoch: int = 0
    # speculative-decoding draft tokens proposed for *this* step by the
    # n-gram drafter (scheduler-owned, consumed by the packer): the engine
    # packs the row as a q = len(spec_tokens)+1 resumed chunk and verifies
    # the drafts in-graph.  Drafts are proposals only — they never enter
    # `output` until the verify launch accepts them.
    spec_tokens: list[int] = dataclasses.field(default_factory=list)

    def discard_speculative(self) -> None:
        """Invalidate in-flight sampled tokens (called on preemption):
        drop the un-filled placeholder, if any, and bump the epoch so the
        engine discards this request's rows from in-flight launches."""
        self._spec_epoch += 1
        self.spec_tokens = []
        if self._placeholder:
            self.output.pop()
            self._placeholder = False

    @property
    def sampling_stream(self) -> int:
        """The RNG stream id this request samples from (see `seed`)."""
        return self.seed if self.seed is not None else self.req_id

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt)

    @property
    def remaining_prompt_tokens(self) -> int:
        return self.num_prompt_tokens - self.num_computed_tokens

    @property
    def prefill_done(self) -> bool:
        return self.num_computed_tokens >= self.num_prompt_tokens

    @property
    def done(self) -> bool:
        if self.eos_token is not None and self.output \
                and self.output[-1] == self.eos_token:
            return True
        return len(self.output) >= self.max_new_tokens

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)


def make_requests(prompts: Sequence[Sequence[int]], **kw) -> list[Request]:
    return [Request(prompt=list(p), **kw) for p in prompts]
