"""Continuous-batching inference engine: the packed, fused-sampling step.

Port of the synchronous main path of `repro.serving.engine.Engine`
(`packed_attention=True, fused_sampling=True`).  Every scheduled piece of
work — decode rows (q = 1), fresh prefill chunks and resumed chunks — is
packed into ONE [1, T] token stream and run by ONE `apply_unified` call
per step, with the last-token gather and sampling inside it:

    token row   0 .. max_seqs-1    the STATIC decode region: one row per
                                   batch slot, dead slots masked by
                                   context_lens == 0
    token row   max_seqs .. T-1    prefill chunks back-to-back, bucketed
                                   to a power-of-two total-token count

Metadata (page tables, context / query lengths, query start locations,
slot mappings, positions) is built host-side in numpy and uploaded once
per step.  The KV cache lives on the engine's device and is written in
place.  On `cuda` the attention runs the hand-written CUDA kernels; with
`device="cpu"` it runs their plain PyTorch versions.

Not ported yet (see ROADMAP.md): the async `submit()/stream()/run()`
loop, speculative decoding, prefix caching, the padded per-kind path,
telemetry / refit, autotuned chunk budgets and the tp executor.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import heuristics
from repro_torch.core.paged.allocator import RefCountedPageAllocator
from repro_torch.models import model as M
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
        seed: int = 0,
        debug_logits: bool = False,
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
        self.cache = M.make_cache(cfg, num_pages=num_pages, device=self.device)
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.step_idx = 0
        self.prefilled_tokens = 0  # prompt tokens actually computed
        self.launched_token_slots = 0  # token rows launched (incl. padding)
        # device calls by kind: a packed step is exactly {"unified": 1}
        self.device_calls: collections.Counter = collections.Counter()
        self._emitted: list[tuple[int, int]] = []  # (req_id, token)/step
        self.last_step_stats: dict | None = None
        self.last_step_logits: torch.Tensor | None = None  # debug_logits
        self.last_generate: dict = {}

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

    def _dispatch(self, profile: heuristics.BatchProfile) \
            -> heuristics.KernelConfig:
        kcfg = heuristics.validate(heuristics.unified_config(profile),
                                   self.cfg.page_size)
        self.dispatch_counts[("unified", kcfg.variant)] += 1
        self._last_dispatch["unified"] = {
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
        if dec.decode_reqs or dec.prefill_reqs:
            batch, pack = self._pack_unified(dec.decode_reqs,
                                             dec.prefill_reqs)
            toks = self._launch_unified(batch, pack)
            self._consume_unified(pack, toks)
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

        kcfg = self._dispatch(profile)
        pack = _PackedLaunch(rows=rows, kcfg=kcfg, tokens=t)
        dev = self.device
        batch = {
            "inputs": torch.from_numpy(tokens).to(dev),
            "positions": torch.from_numpy(pos).to(dev),
            "page_table": torch.from_numpy(pt).to(dev),
            "context_lens": torch.from_numpy(ctx).to(dev),
            "query_lens": torch.from_numpy(qlens).to(dev),
            "query_start_loc": torch.from_numpy(qsl).to(dev),
            "slot_mapping": torch.from_numpy(slots).to(dev),
        }
        temps, topp, topk, streams, ngen = self._sampling_rows(
            s, [(i, r) for r, i in rows])
        batch.update(temperature=temps, top_p=topp, top_k=topk,
                     stream_ids=streams, num_generated=ngen)
        return batch, pack

    def _launch_unified(self, batch: dict, pack: _PackedLaunch) -> np.ndarray:
        """Run one packed launch and return the host token ids [S]."""
        self.device_calls["unified"] += 1
        ret = M.apply_unified(
            self.model, self.cache, batch, kernel_cfg=pack.kcfg,
            num_decode_seqs=self.max_seqs, sample=True, seed=self.seed,
            return_logits=self._debug_logits)
        if self._debug_logits:
            toks, self.last_step_logits, self.cache = ret
        else:
            toks, self.cache = ret
        self.launched_token_slots += pack.tokens
        return toks.cpu().numpy()

    def _consume_unified(self, pack: _PackedLaunch, toks: np.ndarray) -> None:
        """Fold one launch's sampled tokens back into request state."""
        for r, row in pack.rows:
            if r.state is State.FINISHED:
                continue
            self._emit_token(r, int(toks[row]))
