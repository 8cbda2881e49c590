"""Continuous-batching inference engine: the packed, fused-sampling step
and the padded per-kind step.

Port of the synchronous paths of `repro.serving.engine.Engine`.  With
`packed_attention=True` (the default for dense models) every scheduled
piece of work — decode rows (q = 1), fresh prefill chunks and resumed
chunks — is packed into ONE [1, T] token stream and run by ONE
`apply_unified` call per step, with the last-token gather and sampling
inside it:

    token row   0 .. max_seqs-1    the STATIC decode region: one row per
                                   batch slot, dead slots masked by
                                   context_lens == 0
    token row   max_seqs .. T-1    prefill chunks back-to-back, bucketed
                                   to a power-of-two total-token count

The padded per-kind step (`packed_attention=False`, and always for the
hybrid and ssm families, whose slot-indexed recurrent state is not
page-addressable per token) runs each step as `apply_prefill` over the
fresh prompts, padded to a [pow2 batch, pow2 seq >= page] bucket, then
`apply_decode` over the static `max_seqs` decode batch, each followed by
a separate sampling dispatch.  Prefill starts every recurrent slot from
the empty state (zeros, the xLSTM stabilisers at -inf) and merges the
rows back into the slot-indexed cache (`_prefill_cache_view` /
`_merge_prefill_cache`).  A model without attention layers (xlstm) has
no KV pages to address and no attention kernel to configure.

Metadata (page tables, context / query lengths, query start locations,
slot mappings, positions) is built host-side in numpy and uploaded once
per launch.  The caches live on the engine's device and are written in
place.  On `cuda` the attention and the SSD (hybrid) and mLSTM (xlstm)
prefill scans run the hand-written CUDA kernels; with `device="cpu"`
they run their plain PyTorch versions.

The executable cache (`_get_fn` / `_compiled` / `compile_events`, the
reference's names and key) holds one entry per (kind, batch bucket, seq
bucket, KernelConfig): ("unified", 2 * max_seqs, token bucket, kcfg),
("decode", max_seqs, 1, kcfg) and ("prefill", b, s, kcfg).  On the card
(`cuda_graphs=True`, the default) a unified or decode entry is a CUDA
graph (`serving/cuda_graphs.py`): the first step with its key runs
eagerly and captures it, later ones copy their metadata into its static
input buffers and replay it.  The padded prefill's entry stays eager
(each of its (b, s) buckets recurs rarely, so a capture would seldom pay
back), as does the padded step's sampling dispatch.  On the CPU, and on
the card with `cuda_graphs=False`, every entry runs eagerly;
`compile_events` is recorded all the same.  The packed step's sampler is
split: the host draws each sampling row's seeded Gumbel noise into a
static [2 * max_seqs, V] buffer before the step, and the step (captured)
filters and draws.

Not ported yet (see ROADMAP.md): the async `submit()/stream()/run()`
loop, speculative decoding, prefix caching, resumed chunks on the padded
step (`apply_prefill_cached`), telemetry / refit, autotuned chunk budgets
and the tp executor.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import heuristics
from repro_torch.core.paged.allocator import RefCountedPageAllocator
from repro_torch.models import model as M
from repro_torch.models import sampling
from repro_torch.serving import cuda_graphs
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import Scheduler
from repro_torch.utils.misc import cdiv, next_power_of_2

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _PackedLaunch:
    """Host-side record of one unified launch: which request gets which
    sampled row back."""
    rows: list[tuple[Request, int]]  # (request, packed row) of sampling rows
    kcfg: heuristics.KernelConfig
    tokens: int  # launched token-bucket width
    # per-row host arrays [S] that seed the noise: temperature, stream
    # ids, tokens generated so far
    noise_seeds: tuple[np.ndarray, np.ndarray, np.ndarray]


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        model: M.Model,
        *,
        max_seqs: int = 8,
        num_pages: int = 128,
        max_model_len: int = 2048,
        max_prefill_tokens: int = 8192,
        enable_chunked_prefill: bool = False,
        packed_attention: bool = True,
        seed: int = 0,
        debug_logits: bool = False,
        cuda_graphs: bool = True,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.max_seqs = max_seqs
        self.num_pages = num_pages
        self.pages_per_seq = cdiv(max_model_len, cfg.page_size)
        env_tree = heuristics.maybe_load_env()
        if env_tree:
            log.info("engine: attention heuristics from %s", env_tree)
        # kernel-config dispatch steers the paged-attention kernels: none
        # for a model without attention layers (xlstm)
        self._dispatch_enabled = M.attn_layer_count(cfg) > 0
        # the unified token-packed step needs every layer's context to be
        # page-addressable per token: attention families only (the
        # recurrent state of hybrid / ssm models is slot-indexed), as in
        # the reference
        self._packed = packed_attention and cfg.family == "dense"
        if packed_attention and not self._packed:
            log.info("engine: packed attention unavailable for family=%r; "
                     "using the padded per-kind step", cfg.family)
        if enable_chunked_prefill:
            assert cfg.family == "dense", (
                "chunked prefill needs page-addressable context "
                f"(unsupported for family={cfg.family!r})")
            if not self._packed:
                raise NotImplementedError(
                    "chunked prefill on the padded step (resumed chunks, "
                    "apply_prefill_cached) is not ported yet")
        # (prefix caching, the other source of resumed chunks, is not
        # ported: every prefill here starts at context 0)
        self.seed = seed
        self._debug_logits = debug_logits
        self._group = max(1, cfg.num_q_heads // max(cfg.num_kv_heads, 1))
        self.dispatch_counts: collections.Counter = collections.Counter()
        self._last_dispatch: dict[str, dict] = {}
        self.max_prefill_tokens = max_prefill_tokens
        self.alloc = RefCountedPageAllocator(num_pages, cfg.page_size)
        self.sched = Scheduler(self.alloc, max_seqs=max_seqs,
                               max_prefill_tokens=max_prefill_tokens,
                               enable_chunked_prefill=enable_chunked_prefill)
        self.cache = M.make_cache(cfg, max_seqs=max_seqs,
                                  num_pages=num_pages, device=self.device)
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.step_idx = 0
        self.prefilled_tokens = 0  # prompt tokens actually computed
        self.launched_token_slots = 0  # token rows launched (incl. padding)
        # device calls by kind: a packed step is exactly {"unified": 1}; a
        # padded step adds "prefill" / "decode", each with its "sample"
        self.device_calls: collections.Counter = collections.Counter()
        self._emitted: list[tuple[int, int]] = []  # (req_id, token)/step
        self.last_step_stats: dict | None = None
        # debug_logits: the step's logits ([S, V] of the packed launch, or
        # the padded step's prefill rows then its decode rows)
        self.last_step_logits: torch.Tensor | None = None
        self._step_logits: list[torch.Tensor] = []
        self.last_generate: dict = {}
        # the executable cache: key -> entry, one compile event a key
        self.compile_events: list[tuple] = []  # (kind, b, s, kcfg)/capture
        self._compiled: dict[tuple, object] = {}
        # CUDA graphs: the card only; one memory pool and one capture
        # stream for all of the engine's graphs
        self._graphs = cuda_graphs and self.device.type == "cuda"
        self.graph_stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
        if self._graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        # the packed step's static noise buffer (zero on greedy rows)
        self._noise = (torch.zeros((2 * max_seqs, cfg.vocab_size),
                                   dtype=torch.float32, device=self.device)
                       if self._packed else None)
        self._noisy = False  # the buffer holds a nonzero row

    # ------------------------------------------------------------------
    # the executable cache ("graphs")
    # ------------------------------------------------------------------

    def _get_fn(self, kind: str, b: int, s: int,
                kcfg: heuristics.KernelConfig | None = None):
        """Executable cache keyed by (kind, batch bucket, seq bucket,
        KernelConfig), as the reference's: a heuristics tree that switches
        variants by batch shape replays the capture for that config
        (`compile_events` grows one entry per bucket x config, never per
        step).  A unified (b = 2 * max_seqs, s = token bucket) or decode
        entry is a `GraphedStep` on the card with graphs on; a prefill
        entry is always eager (`EagerStep`)."""
        key = (kind, b, s, kcfg)
        if key not in self._compiled:
            self.compile_events.append(key)
            if kind == "unified":
                body = functools.partial(self._unified_body, kcfg)
            elif kind == "decode":
                body = functools.partial(self._decode_body, kcfg)
            elif kind == "prefill":
                body = functools.partial(self._prefill_body, kcfg, b)
            else:
                raise ValueError(kind)
            if self._graphs and kind != "prefill":
                self._compiled[key] = cuda_graphs.GraphedStep(
                    body, self.device, self._graph_pool, self._graph_stream,
                    self.graph_stats)
            else:
                self._compiled[key] = cuda_graphs.EagerStep(body, self.device)
        return self._compiled[key]

    def _unified_body(self, kcfg, batch: dict) -> tuple:
        # a graph always reads the noise buffer (greedy rows ignore it); an
        # eager all-greedy step skips the filter, as the one-call sampler did
        noise = self._noise if self._graphs or self._noisy else None
        toks, logits, _ = M.apply_unified(
            self.model, self.cache["attn"], dict(batch, noise=noise),
            kernel_cfg=kcfg, num_decode_seqs=self.max_seqs, sample=True,
            return_logits=True)
        return toks, logits

    def _decode_body(self, kcfg, batch: dict) -> tuple:
        return M.apply_decode(self.model, self.cache, batch,
                              kernel_cfg=kcfg)[:1]

    def _prefill_body(self, kcfg, b: int, batch: dict) -> tuple:
        return M.apply_prefill(self.model, self._prefill_cache_view(b),
                               batch, kernel_cfg=kcfg)

    # ------------------------------------------------------------------
    # kernel-config dispatch (paper Fig. 5: profile -> tree -> config)
    # ------------------------------------------------------------------

    def _unified_profile(self, decode_reqs: list[Request],
                         prefill_reqs: list[Request]) \
            -> heuristics.BatchProfile:
        nseq = len(decode_reqs) + len(prefill_reqs)
        total = len(decode_reqs) + sum(r.num_scheduled_tokens
                                       for r in prefill_reqs)
        max_ctx = max([r.total_len for r in decode_reqs]
                      + [r.chunk_start + r.num_scheduled_tokens
                         for r in prefill_reqs])
        return heuristics.BatchProfile(
            num_seqs=nseq,
            max_context=next_power_of_2(max_ctx),
            group=self._group, page_size=self.cfg.page_size,
            decode_share=len(decode_reqs) / nseq,
            avg_query_len=next_power_of_2(max(total // nseq, 1)),
            total_tokens=next_power_of_2(total),
        )

    def _decode_profile(self, reqs: list[Request]) -> heuristics.BatchProfile:
        return heuristics.BatchProfile(
            num_seqs=len(reqs),
            max_context=next_power_of_2(max(r.total_len for r in reqs)),
            group=self._group, page_size=self.cfg.page_size,
            decode_share=1.0, avg_query_len=1,
            total_tokens=next_power_of_2(len(reqs)),
        )

    def _prefill_profile(self, reqs: list[Request]) -> heuristics.BatchProfile:
        max_ctx = max(r.chunk_start + r.num_scheduled_tokens for r in reqs)
        total = sum(r.num_scheduled_tokens for r in reqs)
        return heuristics.BatchProfile(
            num_seqs=len(reqs),
            max_context=next_power_of_2(max_ctx),
            group=self._group, page_size=self.cfg.page_size,
            decode_share=0.0,
            avg_query_len=next_power_of_2(max(total // len(reqs), 1)),
            total_tokens=next_power_of_2(total),
        )

    def _dispatch(self, phase: str, profile: heuristics.BatchProfile) \
            -> heuristics.KernelConfig | None:
        """Pick this launch's KernelConfig from the (loaded or default)
        tree of its phase and record it in the dispatch stats; None for a
        model without attention layers."""
        if not self._dispatch_enabled:
            return None
        pick = {"decode": heuristics.decode_config,
                "unified": heuristics.unified_config}.get(
                    phase, heuristics.prefill_config)
        kcfg = heuristics.validate(pick(profile), self.cfg.page_size)
        self.dispatch_counts[(phase, kcfg.variant)] += 1
        self._last_dispatch[phase] = {
            "variant": kcfg.variant, "tile": kcfg.tile,
            "num_segments": kcfg.num_segments, "block_q": kcfg.block_q,
            "num_seqs": profile.num_seqs,
            "max_context": profile.max_context,
            "total_tokens": profile.total_tokens,
        }
        return kcfg

    def _sampling_rows(self, n: int, fill: list[tuple[int, Request]]):
        """Per-row sampling-param arrays ([n] each) with neutral defaults
        on dead rows (temp 0 / top_p 1 / top_k 0 / stream 0 / drawn 0)."""
        temps = np.zeros((n,), np.float32)
        topp = np.ones((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        streams = np.zeros((n,), np.int64)
        ngen = np.zeros((n,), np.int64)
        for i, r in fill:
            temps[i] = r.temperature
            topp[i] = r.top_p
            topk[i] = r.top_k
            streams[i] = r.sampling_stream
            ngen[i] = r.num_generated
        return temps, topp, topk, streams, ngen

    def _emit_token(self, r: Request, tok: int) -> None:
        r.output.append(tok)
        r.num_generated += 1
        self._emitted.append((r.req_id, tok))

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    def add_request(self, req: Request) -> None:
        if req.num_prompt_tokens + req.max_new_tokens > \
                self.pages_per_seq * self.cfg.page_size:
            raise ValueError(
                f"request of {req.num_prompt_tokens} prompt + "
                f"{req.max_new_tokens} new tokens exceeds max_model_len "
                f"{self.pages_per_seq * self.cfg.page_size}")
        self.sched.add(req)

    def generate(self, requests: Sequence[Request],
                 max_steps: int = 10_000) -> list[Request]:
        for r in requests:
            self.add_request(r)
        steps = 0
        while self.sched.has_work and steps < max_steps:
            self.step()
            steps += 1
        unfinished = len(self.sched.waiting) + len(self.sched.running)
        exhausted = unfinished > 0 and steps >= max_steps
        self.last_generate = {"steps": steps, "unfinished": unfinished,
                              "exhausted": exhausted}
        if exhausted:
            log.warning("generate: max_steps=%d exhausted with %d "
                        "request(s) not FINISHED", max_steps, unfinished)
        return list(requests)

    # ------------------------------------------------------------------
    # one engine step
    # ------------------------------------------------------------------

    def step(self) -> dict:
        self._last_dispatch = {}
        self._emitted = []
        self._step_logits = []
        dec = self.sched.step(self.step_idx)
        new_tokens = dec.scheduled_prefill_tokens
        self.prefilled_tokens += new_tokens
        stats = {"prefill": len(dec.prefill_reqs),
                 "decode": len(dec.decode_reqs),
                 "preempted": len(dec.preempted),
                 "prefill_tokens": new_tokens,
                 "partial_prefills": sum(1 for r in dec.prefill_reqs
                                         if not r.prefill_done),
                 "budget_utilization": dec.budget_utilization}
        for req in dec.prefill_reqs:
            row = np.zeros((self.pages_per_seq,), np.int32)
            row[: len(req.pages)] = req.pages
            self.page_table[req.slot] = row
        for req in dec.decode_reqs:  # page growth
            row = self.page_table[req.slot]
            row[: len(req.pages)] = req.pages
        if self._packed:
            if dec.decode_reqs or dec.prefill_reqs:
                batch, pack = self._pack_unified(dec.decode_reqs,
                                                 dec.prefill_reqs)
                toks = self._launch_unified(batch, pack)
                self._consume_unified(pack, toks)
        else:
            # padded per-kind step: each launch samples its own rows; every
            # prefill is fresh (context 0: no chunking on this step)
            if dec.prefill_reqs:
                self._run_prefill_fresh(dec.prefill_reqs)
            if dec.decode_reqs:
                self._run_decode(dec.decode_reqs)
            if self._debug_logits and self._step_logits:
                self.last_step_logits = torch.cat(self._step_logits)
        for req in list(self.sched.running):
            if req.prefill_done and req.done:
                slot = req.slot  # finish() releases the slot
                self.sched.finish(req)
                if slot is not None:
                    self.page_table[slot] = 0
        stats["dispatch"] = dict(self._last_dispatch)
        stats["pool"] = self.alloc.mesh_stats(1)
        stats["sampled_tokens"] = len(self._emitted)
        self.step_idx += 1
        self.last_step_stats = stats
        return stats

    def _page_slots(self, row: np.ndarray, positions: np.ndarray) \
            -> np.ndarray:
        """Pool-local flat KV slots for in-sequence `positions` through one
        page-table row."""
        ps = self.cfg.page_size
        return row[positions // ps] * ps + positions % ps

    def _pack_unified(self, decode_reqs: list[Request],
                      prefill_reqs: list[Request]) \
            -> tuple[dict, _PackedLaunch]:
        """Build the batch for ONE token-packed launch.

        Rows [0, max_seqs) are the static decode region (decode rows
        sorted by pow2 context bucket, dead rows ctx = 0 with qlen = 1);
        prefill chunks pack back-to-back behind it, the chunk-token count
        bucketed to a power of two (at least one page).  The sequence axis
        is static at 2 * max_seqs and the page table full-width.  Only
        decode rows and prompt-completing chunks sample.  Each request's
        `context_len` advances here."""
        ms = self.max_seqs
        ps = self.cfg.page_size
        plain = sorted(decode_reqs,
                       key=lambda r: next_power_of_2(max(r.total_len, 1)))
        if len(prefill_reqs) > ms:
            raise RuntimeError("chunk region overflow: more chunks than "
                               "max_seqs")
        profile = self._unified_profile(decode_reqs, prefill_reqs)
        n_pref = sum(r.num_scheduled_tokens for r in prefill_reqs)
        t = ms + (max(next_power_of_2(n_pref), ps) if n_pref else 0)
        s = 2 * ms
        np_b = self.pages_per_seq
        trash = self.num_pages * ps  # out-of-range slot: writes dropped

        tokens = np.zeros((1, t), np.int64)
        pos = np.zeros((1, t), np.int64)
        slots = np.full((1, t), trash, np.int64)
        qlens = np.zeros((s,), np.int32)
        ctx = np.zeros((s,), np.int32)
        pt = np.zeros((s, np_b), np.int32)
        qsl = np.full((s + 1,), ms, np.int32)
        qsl[:ms + 1] = np.arange(ms + 1)
        qlens[:ms] = 1  # dead decode rows are masked by ctx == 0
        rows: list[tuple[Request, int]] = []
        for i, r in enumerate(plain):
            tokens[0, i] = r.output[-1] if r.output else r.prompt[-1]
            p = r.total_len - 1
            pos[0, i] = p
            ctx[i] = r.total_len
            row = self.page_table[r.slot]
            pt[i] = row[:np_b]
            slots[0, i] = self._page_slots(row, np.asarray(p))
            rows.append((r, i))
            r.context_len = r.total_len
        cur = ms
        for j, r in enumerate(prefill_reqs):
            i = ms + j
            n = r.num_scheduled_tokens
            tokens[0, cur: cur + n] = r.prompt[r.chunk_start: r.chunk_start + n]
            p = np.arange(r.chunk_start, r.chunk_start + n, dtype=np.int64)
            ctx[i] = r.chunk_start + n
            if r.chunk_start + n == r.num_prompt_tokens:
                rows.append((r, i))  # prompt-completing chunk: samples
            r.context_len = r.chunk_start + n
            pos[0, cur: cur + n] = p  # packed-position RoPE: absolute
            qlens[i] = n
            row = self.page_table[r.slot]
            pt[i] = row[:np_b]
            slots[0, cur: cur + n] = self._page_slots(row, p)
            cur += n
            qsl[i + 1:] = cur

        kcfg = self._dispatch("unified", profile)
        temps, topp, topk, streams, ngen = self._sampling_rows(
            s, [(i, r) for r, i in rows])
        pack = _PackedLaunch(rows=rows, kcfg=kcfg, tokens=t,
                             noise_seeds=(temps, streams, ngen))
        batch = {"inputs": tokens, "positions": pos, "page_table": pt,
                 "context_lens": ctx, "query_lens": qlens,
                 "query_start_loc": qsl, "slot_mapping": slots,
                 "temperature": temps, "top_p": topp, "top_k": topk}
        return batch, pack

    def _draw_noise(self, pack: _PackedLaunch) -> None:
        """The sampler's host part: each sampling row's Gumbel noise,
        seeded from (seed, stream id, tokens generated), into the static
        buffer (zeroed where no row samples; untouched while it stays
        all zero)."""
        temps, streams, ngen = pack.noise_seeds
        hot = sampling.hot_rows(temps)
        if hot or self._noisy:
            sampling.gumbel_noise(self.seed, streams, ngen,
                                  self.cfg.vocab_size, self.device, rows=hot,
                                  out=self._noise)
        self._noisy = bool(hot)

    def _launch_unified(self, batch: dict, pack: _PackedLaunch) -> np.ndarray:
        """Run one packed launch (host arrays in, through the executable
        cache) and return the host token ids [S]."""
        fn = self._get_fn("unified", 2 * self.max_seqs, pack.tokens,
                          pack.kcfg)
        self.device_calls["unified"] += 1
        self._draw_noise(pack)
        toks, logits = fn(batch)
        if self._debug_logits:  # a copy: a replay overwrites the buffer
            self.last_step_logits = logits.clone()
        self.launched_token_slots += pack.tokens
        return toks.cpu().numpy()

    def _consume_unified(self, pack: _PackedLaunch, toks: np.ndarray) -> None:
        """Fold one launch's sampled tokens back into request state."""
        for r, row in pack.rows:
            if r.state is State.FINISHED:
                continue
            self._emit_token(r, int(toks[row]))

    # ------------------------------------------------------------------
    # the padded per-kind step
    # ------------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, n: int,
                fill: list[tuple[int, Request]]) -> np.ndarray:
        """The padded step's separate sampling dispatch: the same
        per-request-stream draw as the fused sampler, host token ids [n]."""
        self.device_calls["sample"] += 1
        temps, topp, topk, streams, ngen = self._sampling_rows(n, fill)
        return sampling.sample_rows(logits, self.seed, temps, topp, topk,
                                    streams, ngen).cpu().numpy()

    def _finish_chunk(self, reqs: list[Request], logits: torch.Tensor) \
            -> None:
        """Advance progress; sample first tokens for prompts now complete."""
        done = [(i, r) for i, r in enumerate(reqs)
                if r.chunk_start + r.num_scheduled_tokens
                == r.num_prompt_tokens]
        if done:
            toks = self._sample(logits, logits.shape[0], done)
            for i, r in done:
                self._emit_token(r, int(toks[i]))
        for r in reqs:
            r.context_len = r.chunk_start + r.num_scheduled_tokens

    def _run_prefill_fresh(self, reqs: list[Request]) -> None:
        """The padded prefill of fresh prompts, [pow2 batch, pow2 seq]: its
        ("prefill", b, s, kcfg) key is recorded in `compile_events`, but
        its entry stays eager, also on the card (each bucket recurs
        rarely, so a capture would seldom pay back)."""
        b = next_power_of_2(len(reqs))
        max_len = max(r.num_scheduled_tokens for r in reqs)
        s = max(next_power_of_2(max_len), self.cfg.page_size)
        tokens = np.zeros((b, s), np.int64)
        qlens = np.zeros((b,), np.int32)
        pt = np.zeros((b, self.pages_per_seq), np.int32)
        pos = np.tile(np.arange(s, dtype=np.int64)[None], (b, 1))
        for i, r in enumerate(reqs):
            n = r.num_scheduled_tokens
            tokens[i, :n] = r.prompt[:n]
            qlens[i] = n
            pt[i] = self.page_table[r.slot]
        kcfg = self._dispatch("prefill", self._prefill_profile(reqs))
        fn = self._get_fn("prefill", b, s, kcfg)  # eager in this port
        self.device_calls["prefill"] += 1
        logits, new_cache = fn({"inputs": tokens, "positions": pos,
                                "page_table": pt, "context_lens": qlens,
                                "query_lens": qlens})
        if self._debug_logits:
            self._step_logits.append(logits)
        self.launched_token_slots += b * s
        self._merge_prefill_cache(new_cache, [r.slot for r in reqs])
        self._finish_chunk(reqs, logits)

    def _run_decode(self, reqs: list[Request]) -> None:
        b = self.max_seqs  # static decode batch (paper C5)
        tokens = np.zeros((b, 1), np.int64)
        pos = np.full((b, 1), -1, np.int64)
        ctx = np.zeros((b,), np.int32)
        for r in reqs:
            tokens[r.slot, 0] = r.output[-1] if r.output else r.prompt[-1]
            pos[r.slot, 0] = r.total_len - 1
            ctx[r.slot] = r.total_len
        kcfg = self._dispatch("decode", self._decode_profile(reqs))
        fn = self._get_fn("decode", b, 1, kcfg)
        self.device_calls["decode"] += 1
        logits, = fn({"inputs": tokens, "positions": pos,
                      "page_table": self.page_table.copy(),
                      "context_lens": ctx})
        if self._debug_logits:  # a copy: a replay overwrites the buffer
            self._step_logits.append(logits.clone())
        self.launched_token_slots += b
        toks = self._sample(logits, b, [(r.slot, r) for r in reqs])
        for r in reqs:
            r.context_len = r.total_len
            self._emit_token(r, int(toks[r.slot]))

    # ------------------------------------------------------------------
    # slot-indexed (SSM) cache plumbing
    # ------------------------------------------------------------------

    def _prefill_cache_view(self, b: int) -> dict:
        """The attention pages (where the model has any) are global; the
        recurrent rows of a prefill start from the empty state, zeros with
        the mLSTM / sLSTM stabilisers `m` at -inf, as `M.make_cache` makes
        them (prefill always begins at context 0 on the padded step)."""
        view = {}
        for k, leaves in self.cache.items():
            if k == "attn":
                view[k] = leaves
                continue
            view[k] = {n: torch.zeros(t.shape[:1] + (b,) + t.shape[2:],
                                      dtype=t.dtype, device=t.device)
                       for n, t in leaves.items()}
            if k in ("mlstm", "slstm"):
                view[k]["m"].fill_(-torch.inf)
        return view

    def _merge_prefill_cache(self, new_cache: dict, slots: list[int]) -> None:
        """Copy the prefilled rows of each recurrent leaf (Mamba2's conv /
        ssm, the mLSTM's conv / c / n / m, the sLSTM's h / c / n / m) into
        their slots."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for k, leaves in new_cache.items():
            if k != "attn":
                for n, t in leaves.items():
                    self.cache[k][n].index_copy_(1, idx, t[:, :len(slots)])
