"""Continuous-batching inference engine: the packed, fused-sampling step
and the padded per-kind step.

Port of `repro.serving.engine.Engine`.  With
`packed_attention=True` (the default for the dense, moe, audio and vlm
families; M-RoPE models get [3, 1, T] positions, `_positions`) every scheduled
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
page-addressable per token, and for MLA, whose latent decode has one
fixed path, as in the reference) runs each step as `apply_prefill` over the
fresh prompts, padded to a [pow2 batch, pow2 seq >= page] bucket, then
`apply_decode` over the static `max_seqs` decode batch, each followed by
a separate sampling dispatch.  Prefill starts every recurrent slot from
the empty state (zeros, the xLSTM stabilisers at -inf) and merges the
rows back into the slot-indexed cache (`_prefill_cache_view` /
`_merge_prefill_cache`).  A model without attention layers (xlstm) has
no KV pages to address and no attention kernel to configure; an MLA
model has pages but no kernel configuration either.

Metadata (page tables, context / query lengths, query start locations,
slot mappings, positions) is built host-side in numpy and uploaded once
per launch.  The caches live on the engine's device and are written in
place.  On `cuda` the attention and the SSD (hybrid) and mLSTM (xlstm)
prefill scans run the hand-written CUDA kernels; with `device="cpu"`
they run their plain PyTorch versions.

The executable cache (`_get_fn` / `_compiled` / `compile_events`, the
reference's names and key) holds one entry per (kind, batch bucket, seq
bucket, KernelConfig): ("unified", 2 * max_seqs, token bucket, kcfg),
("decode", max_seqs, 1, kcfg), ("prefill", b, s, kcfg) and
("prefill_cached/np{np_b}", b, s, kcfg).  On the card
(`cuda_graphs=True`, the default) a unified or decode entry is a CUDA
graph (`serving/cuda_graphs.py`): the first step with its key runs
eagerly and captures it, later ones copy their metadata into its static
input buffers and replay it.  The padded prefill's entries stay eager
(each of its (b, s) buckets recurs rarely, so a capture would seldom pay
back), as does the padded step's sampling dispatch.  On the CPU, and on
the card with `cuda_graphs=False`, every entry runs eagerly;
`compile_events` is recorded all the same.  The packed step's sampler is
split: the host draws each sampling row's seeded Gumbel noise into a
static [2 * max_seqs, V] buffer before the step, and the step (captured)
filters and draws.

Async double-buffered serving (`submit()` / `stream()` / `run()`): on the
packed step the streaming loop schedules, packs and DISPATCHES step N+1
before it reads step N's sampled ids, so the host's work overlaps the
card's.  A decode row whose input token is still in flight reads it on
the card (`prev_tokens[token_source]` inside the step; `prev_tokens` is
the previous launch's device ids, a device input of the entry, copied on
the stream into a graph's static buffer before its replay); on the host a
PENDING_TOKEN placeholder holds its output position, so lengths, paging
and max_new_tokens stay exact, and a finish lands one step late.  A row
of a request that finished, or was preempted (its `_spec_epoch` moved),
while its launch was in flight is discarded.  Each launch's ids leave
the card through one of two pinned host buffers (`TokenCopies`), copied
asynchronously right behind the launch, since the next replay of the
same graph overwrites its output buffer.  `token_source` and
`prev_tokens` are in every packed launch, so one graph per key serves
synchronous and async steps.  The padded step steps synchronously under
`stream()`, with the same yields.

Prefix caching (`enable_prefix_caching=True`, dense and moe): admission
reuses the longest chain of cached full pages, and the prompt's chunk
resumes at that context.  Chunked prefill (`enable_chunked_prefill`)
splits prompts into budget-sized chunks.  On the packed step a resumed
chunk is a chunk row with context > query; on the padded step it runs
`apply_prefill_cached` (entry ("prefill_cached/np{np_b}", b, s, kcfg),
eager, `np_b` the page-table width bucket), the Q-Block prefill over the
whole paged context.

Two-dispatch sampling (`fused_sampling=False`, packed step only): the
packed launch returns the [S, V] last-token logits and a second,
eager dispatch (`_host_tokens`) samples them, so a step is {"unified": 1,
"sample": 1} device calls; the packed launch is graphed or eager as on the fused
path, and `stream()` steps synchronously.  The tokens are the fused
step's, bit for bit (one sampler, one noise per (seed, stream,
counter)).

Speculative decoding (`speculative=True`, needs the fused packed step):
the scheduler asks the n-gram `Drafter` (`serving/draft.py`) for up to
`draft_k` drafts per decode request and grows its pages to cover them; a
drafted request leaves the decode region and packs as a resumed chunk of
q = s + 1 tokens [last real token, draft_1..draft_s] at positions
total_len - 1.., and the packed launch verifies it in the same graph
(`apply_unified(max_draft=K)`): it samples K + 1 targets a row, each at
the counter sequential decoding would use, and returns [S, K+1] tokens
and [S] accept counts, which leave the card in one pinned copy.  The
host emits the accepted drafts and the bonus token and rolls back
exactly: `context_len` covers the kept tokens only, and the pages grown
past them go back through the ref-counted allocator (always this step's
fresh pages, never a shared or cached one).  Tokens are the
non-speculative engine's, greedy and sampled, as far as the two
attention paths round alike (a verify row runs the Q-Block prefill, a
decode row the decode kernel): in fp32 they do; in bf16 a near-tie can
go either way.  A spec engine's graphs
always carry the wider outputs, and its noise buffer is
[2 * max_seqs * (K + 1), V].  `stream()` steps synchronously: step N's
accept counts decide step N+1's metadata.

Telemetry (`Engine(telemetry=obs.Telemetry(...))`): the reference's
hooks at the reference's sites.  Step phases (schedule, pack, launch,
sample, host, overlap) are timed on the host around the same regions;
the scheduler and prefix cache count their events; each launch records
its kind, profile and KernelConfig, and every `launch_timing_interval`-th
warm launch (every first launch of a key, a capture, always) is timed by
synchronising the stream on its output, the counterpart of the
reference's `block_until_ready`.  Warm timed launches build the latency
grid, each entry stamped with `_exe_cost`'s analytic count of its key's
work.  Without telemetry no hook runs and nothing synchronises.  A
`RefitDaemon` (`refit=`) refits the heuristics trees from that grid and
hot-swaps them between steps (`_finish_padded`); a configuration a new
tree picks captures its graph at first use, as any new key does.
`max_prefill_tokens="auto"` takes a loaded tree's exported budget, else
the Hopper cost model's (`autotune.costmodel`).

Tensor parallelism (`Engine(tp=N, tp_group=G)`, packed step only): the
step runs through `serving/executor.py`'s `TensorParallelExecutor` on
every rank of a `torch.distributed` group of N ranks (None: the default
group), each rank holding Hkv / N heads of the KV pool and of `wq` / `wk`
/ `wv`, with one all-gather of the attention output a layer.  Every rank
runs the same engine on the same requests: the host schedule is
deterministic and the sampled tokens come from replicated logits, so
every rank packs the same batch each step and makes one step call
(`device_calls == {"unified": steps}`).  The step runs eager
(`cuda_graphs=True` on the card raises `ShardingError`); a step's `"pool"`
is `alloc.mesh_stats(tp)`, the telemetry's and `BatchProfile`'s `tp` is
N.  The engine's model becomes this rank's shard (cut in place).
"""
from __future__ import annotations

import collections
import contextlib
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
from repro_torch.serving.cuda_graphs import TokenCopies
from repro_torch.serving.draft import Drafter, SpecConfig
from repro_torch.serving.executor import make_executor
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import PENDING_TOKEN, Request, State
from repro_torch.serving.scheduler import Scheduler
from repro_torch.utils.misc import cdiv, next_power_of_2

log = logging.getLogger(__name__)


def _page_addressable(cfg: ModelConfig) -> bool:
    """Every layer's context lives in the KV pages, per token: the
    attention families without MLA (the packed step, prefix caching and
    chunked prefill need it), as the reference's gates read."""
    return cfg.family in M.DECODER_FAMILIES and not cfg.mla.kv_lora_rank


@dataclasses.dataclass
class _PackedLaunch:
    """Host-side record of one unified launch: which request gets which
    sampled row back."""
    # (request, packed row, request._spec_epoch at pack time) of every
    # row that samples: the epoch lets the async loop discard rows whose
    # request was preempted while the launch was in flight
    rows: list[tuple[Request, int, int]]
    prefill_reqs: list[Request]  # the chunk rows' requests (telemetry)
    profile: heuristics.BatchProfile
    kcfg: heuristics.KernelConfig
    tokens: int  # launched token-bucket width
    # per-row host arrays [S] of the sampler: temperature, top_p, top_k,
    # stream ids, tokens drawn so far
    sampling: tuple[np.ndarray, ...]
    # [S]: the drafts each packed row verifies (it emits 1..drafts+1
    # tokens); zeros on a launch without spec rows
    spec_lens: np.ndarray


@dataclasses.dataclass
class _Inflight:
    """One dispatched engine step whose sampled ids the host has not read
    yet (the async loop's double-buffer slot)."""
    dec: object  # the scheduler's decision
    stats: dict
    t0: float  # the step's start on the telemetry clock (0 without)
    pack: _PackedLaunch | None = None
    # the launch's device ids ([S]; [S, K+2] on a speculative engine)
    toks: torch.Tensor | None = None
    host: int = -1  # its `TokenCopies` buffer
    # [S, V]: a copy under debug_logits; the two-dispatch step's logits
    logits: torch.Tensor | None = None


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        model: M.Model,
        *,
        max_seqs: int = 8,
        num_pages: int = 128,
        max_model_len: int = 2048,
        max_prefill_tokens: int | str = 8192,
        enable_prefix_caching: bool = False,
        enable_chunked_prefill: bool = False,
        packed_attention: bool = True,
        fused_sampling: bool = True,
        speculative: bool = False,
        draft_k: int = 4,
        spec_config: SpecConfig | None = None,
        seed: int = 0,
        debug_logits: bool = False,
        cuda_graphs: bool = True,
        telemetry=None,
        refit=None,
        device="cuda",
        tp: int = 1,
        tp_group=None,
    ):
        self.cfg = cfg
        self.tp = tp
        self.device = torch.device(device)
        self.model = model.to(self.device)
        # obs.Telemetry | None.  None (the default) disables every hook
        # and the timing synchronisations: the serving loop stays exactly
        # as asynchronous as without it.
        self.telemetry = telemetry
        # obs.RefitDaemon | None: after every finished step the engine
        # applies any pending heuristics hot-swap (and, in the daemon's
        # inline mode, evaluates its refit trigger); swaps happen only
        # BETWEEN steps, so a step never sees two trees.
        self.refit = refit
        if refit is not None and (telemetry is None
                                  or refit.telemetry is not telemetry):
            raise ValueError("the refit daemon must watch this engine's "
                             "telemetry")
        if telemetry is not None:
            telemetry.set_arch(
                num_q_heads=cfg.num_q_heads,
                num_kv_heads=max(cfg.num_kv_heads, 1),
                head_dim=cfg.resolved_head_dim,
                page_size=cfg.page_size,
                tp=tp)
        self.max_seqs = max_seqs
        self.num_pages = num_pages
        self.pages_per_seq = cdiv(max_model_len, cfg.page_size)
        env_tree = heuristics.maybe_load_env()
        if env_tree:
            log.info("engine: attention heuristics from %s", env_tree)
        # kernel-config dispatch steers the paged-attention kernels: none
        # for a model without attention layers (xlstm), nor for MLA, whose
        # latent decode has one path (compile keys carry None, as the
        # reference's)
        self._dispatch_enabled = (M.attn_layer_count(cfg) > 0
                                  and not cfg.mla.kv_lora_rank)
        # the unified token-packed step needs every layer's context to be
        # page-addressable per token: attention families only (the
        # recurrent state of hybrid / ssm models is slot-indexed), as in
        # the reference
        self._packed = packed_attention and _page_addressable(cfg)
        if packed_attention and not self._packed:
            log.info("engine: packed attention unavailable for "
                     "family=%r/MLA; using the padded per-kind step",
                     cfg.family)
        # sampling inside the packed launch is a packed-step feature; the
        # padded step always samples in a second dispatch
        self._fused = fused_sampling and self._packed
        if fused_sampling and not self._packed:
            log.info("engine: fused sampling needs the packed step; "
                     "using the two-dispatch sampler")
        # the verify epilogue rides in the fused packed launch
        self._spec = bool(speculative) and self._fused
        if speculative and not self._spec:
            log.info("engine: speculative decoding needs the fused packed "
                     "step; running non-speculative")
        self.drafter = None
        self.max_draft = 0
        if self._spec:
            scfg = spec_config or SpecConfig(max_draft=max(1, draft_k))
            self.drafter = Drafter(scfg)
            self.max_draft = scfg.max_draft
        # cumulative: drafts proposed, drafts accepted, tokens emitted by
        # spec rows, steps with a spec row (per-step values in the stats)
        self.spec_stats = {"proposed": 0, "accepted": 0, "emitted": 0,
                           "steps": 0}
        self._step_spec = (0, 0, 0)  # (proposed, accepted, emitted)
        # CUDA graphs: the card only; one memory pool and one capture
        # stream for all of the engine's graphs
        self._graphs = cuda_graphs and self.device.type == "cuda"
        # where the packed step runs: tp = 1 calls `apply_unified` as it
        # always has; tp > 1 runs this rank's head block of it, with the
        # model's qkv leaves cut to the rank's heads and its KV pool
        # allocated at them
        self.executor = make_executor(
            cfg, tp=tp, group=tp_group, max_seqs=max_seqs,
            fused=self._fused, packed=self._packed,
            max_draft=self.max_draft, graphs=self._graphs)
        self.model = self.executor.place_params(self.model)
        if enable_prefix_caching or enable_chunked_prefill:
            assert _page_addressable(cfg), (
                "prefix caching / chunked prefill need page-addressable "
                f"context (unsupported for family={cfg.family!r}/MLA)")
        self.seed = seed
        self._debug_logits = debug_logits
        self._group = max(1, cfg.num_q_heads // max(cfg.num_kv_heads, 1))
        self.dispatch_counts: collections.Counter = collections.Counter()
        self._last_dispatch: dict[str, dict] = {}
        if max_prefill_tokens == "auto":
            # chunk-size autotuner: the per-step budget from the cost
            # model's decode-latency roofline (a loaded tree's export wins)
            from repro_torch.autotune.costmodel import \
                suggest_max_prefill_tokens
            max_prefill_tokens = (
                heuristics.suggested_max_prefill_tokens()
                or suggest_max_prefill_tokens(
                    num_q_heads=cfg.num_q_heads,
                    num_kv_heads=max(cfg.num_kv_heads, 1),
                    head_dim=cfg.resolved_head_dim,
                    page_size=cfg.page_size, max_seqs=max_seqs,
                    target_context=max_model_len))
            if not enable_chunked_prefill:
                # unchunked, the budget gates whole prompts: a prompt
                # longer than it would wait forever, so admit any prompt
                # that fits a sequence
                max_prefill_tokens = max(max_prefill_tokens, max_model_len)
            log.info("engine: autotuned max_prefill_tokens=%d",
                     max_prefill_tokens)
        self.max_prefill_tokens = max_prefill_tokens
        self.alloc = RefCountedPageAllocator(num_pages, cfg.page_size)
        self.prefix_cache = (PrefixCache(self.alloc, cfg.page_size,
                                         telemetry=telemetry)
                             if enable_prefix_caching else None)
        self.sched = Scheduler(self.alloc, max_seqs=max_seqs,
                               max_prefill_tokens=max_prefill_tokens,
                               prefix_cache=self.prefix_cache,
                               enable_chunked_prefill=enable_chunked_prefill,
                               telemetry=telemetry, drafter=self.drafter)
        self.cache = self.executor.place_cache(
            max_seqs=max_seqs, num_pages=num_pages, device=self.device)
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.step_idx = 0
        self.prefilled_tokens = 0  # uncached prompt tokens computed
        self.cached_prefill_tokens = 0  # tokens skipped via the prefix cache
        self.launched_token_slots = 0  # token rows launched (incl. padding)
        # device calls by kind: a packed step is exactly {"unified": 1}; a
        # padded step adds "prefill" / "prefill_cached" / "decode", each
        # with its "sample"
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
        # key -> {"flops", "bytes_accessed"}: `_exe_cost`, stamped once
        # per key (telemetry only)
        self._launch_costs: dict[tuple, dict] = {}
        self.graph_stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
        if self._graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        # the fused packed step's static noise buffer (zero on greedy rows;
        # K + 1 rows a sequence on a spec engine), its `prev_tokens` of a
        # launch with no launch in flight, and the two host buffers its
        # sampled ids leave the card through
        self._noise = self._no_prev = self._copies = None
        if self._packed:
            self._no_prev = torch.zeros((2 * max_seqs,), dtype=torch.int32,
                                        device=self.device)
        if self._fused:
            k1 = self.max_draft + 1
            self._noise = torch.zeros((2 * max_seqs * k1, cfg.vocab_size),
                                      dtype=torch.float32, device=self.device)
            self._copies = TokenCopies(
                (2 * max_seqs, k1 + 1) if self._spec else (2 * max_seqs,),
                self.device)
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
        entry is a `GraphedStep` on the card with graphs on; a prefill or
        resumed-prefill entry is always eager (`EagerStep`)."""
        key = (kind, b, s, kcfg)
        if key not in self._compiled:
            self.compile_events.append(key)
            if kind == "unified":
                body = functools.partial(self._unified_body,
                                         self.executor.build_unified(kcfg))
            elif kind == "decode":
                body = functools.partial(self._decode_body, kcfg)
            elif kind == "prefill":
                body = functools.partial(self._prefill_body, kcfg, b,
                                         M.apply_prefill)
            elif kind.startswith("prefill_cached"):
                body = functools.partial(self._prefill_body, kcfg, b,
                                         M.apply_prefill_cached)
            else:
                raise ValueError(kind)
            if self._graphs and kind in ("unified", "decode"):
                self._compiled[key] = cuda_graphs.GraphedStep(
                    body, self.device, self._graph_pool, self._graph_stream,
                    self.graph_stats)
            else:
                self._compiled[key] = cuda_graphs.EagerStep(body, self.device)
        return self._compiled[key]

    def _unified_body(self, step, batch: dict) -> tuple:
        """(ids, last logits [S, V]) fused; (last logits,) two-dispatch.
        A spec engine's ids are [S, K+2]: the verify tokens, then the
        accept count.  `step` is the executor's `build_unified` callable
        of the launch's kernel config."""
        if not self._fused:
            logits, _ = step(self.model, self.cache["attn"], batch)
            return (logits,)
        # a graph always reads the noise buffer (greedy rows ignore it); an
        # eager all-greedy step skips the filter, as the one-call sampler did
        noise = self._noise if self._graphs or self._noisy else None
        *ids, logits, _ = step(self.model, self.cache["attn"],
                               dict(batch, noise=noise))
        if self._spec:
            toks, emitted = ids
            return torch.cat([toks, emitted[:, None]], dim=1), logits
        return ids[0], logits

    def _decode_body(self, kcfg, batch: dict) -> tuple:
        return M.apply_decode(self.model, self.cache, batch,
                              kernel_cfg=kcfg)[:1]

    def _prefill_body(self, kcfg, b: int, apply, batch: dict) -> tuple:
        return apply(self.model, self._prefill_cache_view(b), batch,
                     kernel_cfg=kcfg)

    # ------------------------------------------------------------------
    # device-side timing (telemetry only)
    # ------------------------------------------------------------------

    def _launch_ctx(self, kind: str):
        """`torch.profiler.record_function("repro.launch.<kind>")` around
        a launch, so a device profile (`serve --profile`) attributes
        device time to the launch kind; a no-op without telemetry."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"repro.launch.{kind}")

    @staticmethod
    def _wait(out: torch.Tensor) -> None:
        """A timed launch's barrier: the host waits until the stream that
        produced `out` has run it (the reference's `block_until_ready`)."""
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()

    @functools.cached_property
    def _matrix_params(self) -> int:
        """Weights each token's row is multiplied by once: every matrix of
        the model but the embedding and the head, the hybrid's shared
        block once per invocation, a MoE layer's expert stacks top_k / E
        of them (a row meets its top_k experts)."""
        skip = ("embed", "lm_head")
        moe = self.cfg.moe
        n = sum(p.numel() * moe.top_k // moe.num_experts
                if p.ndim == 3 and ".moe." in name else p.numel()
                for name, p in self.model.named_parameters()
                if p.ndim >= 2 and not name.startswith(skip))
        if self.cfg.family == "hybrid":
            n += (M.attn_layer_count(self.cfg) - 1) * sum(
                p.numel() for p in self.model.shared.parameters()
                if p.ndim >= 2)
        return n

    def _exe_cost(self, key: tuple) -> dict:
        """Analytic work of the static launch behind executable-cache key
        `key` = (kind, b, s, kcfg), memoised per key.  The reference
        stamps XLA's `cost_analysis` of the executable here; PyTorch has
        none, so this counts what the key's launch is shaped for, whatever
        rows of it are live:

          flops  2 x rows x (the model's matrix weights) for the
                 projections and MLPs, 2 x seqs x d_model x vocab for the
                 head, and 4 x rows x width x Hq x D per attention layer
                 (QK and PV over the static page-table width)
          bytes  the weights once, K and V of the static width per
                 attention layer, a layer's activations in and out per
                 row, and the fp32 logits

        where rows is the token bucket (unified: s; decode: b; prefill:
        b x s), seqs the batch rows (b) and width the page table's keys
        (`pages_per_seq` pages; a resumed prefill's `np{n}` bucket: n).
        Every grid entry then carries `flops` and `bytes_accessed`, the
        device-time floor `tune.refit_from_telemetry` splits host
        overhead against."""
        cost = self._launch_costs.get(key)
        if cost is not None:
            return cost
        kind, b, s, _ = key
        cfg = self.cfg
        rows = {"unified": s, "decode": b}.get(kind, b * s)
        pages = self.pages_per_seq
        if kind.startswith("prefill_cached/np"):
            pages = int(kind.rsplit("np", 1)[1])
        width = pages * cfg.page_size
        n_attn = M.attn_layer_count(cfg)
        hd = cfg.resolved_head_dim
        item = self.model.embed.element_size()
        flops = (2.0 * rows * self._matrix_params
                 + 2.0 * b * cfg.d_model * cfg.vocab_size
                 + 4.0 * rows * width * cfg.num_q_heads * hd * n_attn)
        weights = sum(p.numel() for p in self.model.parameters()) * item
        kv = 2.0 * b * width * max(cfg.num_kv_heads, 1) * hd * item * n_attn
        acts = 2.0 * rows * cfg.d_model * item * cfg.num_layers
        cost = {"flops": flops,
                "bytes_accessed": weights + kv + acts
                + 4.0 * b * cfg.vocab_size}
        self._launch_costs[key] = cost
        return cost

    def _record_launch(self, kind: str, key: tuple, profile, kcfg,
                       t_launch: float, out: torch.Tensor, pre: int, *,
                       tokens: int, grid_phase: str | None = None) -> None:
        """Telemetry of one launch (the reference's per-site block): a
        first launch of a key (a capture: `compile_events` grew past
        `pre`) is always timed, a warm one every `launch_timing_interval`
        launches; a timed launch waits for `out` before its end time.
        The key's cost is stamped after the record, so it never counts in
        the launch's time."""
        tel = self.telemetry
        compiled = len(self.compile_events) > pre
        timed = compiled or tel.time_this_launch()
        if timed:
            self._wait(out)
        tel.record_launch(kind, profile, kcfg, t_launch, tel.clock.now(),
                          compiled=compiled, tokens=tokens,
                          grid_phase=grid_phase, timed=timed,
                          cost=self._launch_costs.get(key))
        if compiled:
            self._exe_cost(key)

    # ------------------------------------------------------------------
    # kernel-config dispatch (paper Fig. 5: profile -> tree -> config)
    # ------------------------------------------------------------------

    def _unified_profile(self, decode_reqs: list[Request],
                         prefill_reqs: list[Request],
                         spec_total: int = 0) -> heuristics.BatchProfile:
        """The packed step's profile; `spec_total` (drafts verified this
        step) is its own pow2 dimension, `spec_tokens`, as in the
        reference, so a loaded tree that splits on it picks the same."""
        nseq = len(decode_reqs) + len(prefill_reqs)
        total = len(decode_reqs) + spec_total + sum(
            r.num_scheduled_tokens for r in prefill_reqs)
        max_ctx = max([r.total_len + len(r.spec_tokens) for r in decode_reqs]
                      + [r.chunk_start + r.num_scheduled_tokens
                         for r in prefill_reqs])
        return heuristics.BatchProfile(
            num_seqs=nseq,
            max_context=next_power_of_2(max_ctx),
            group=self._group, page_size=self.cfg.page_size,
            decode_share=len(decode_reqs) / nseq,
            avg_query_len=next_power_of_2(max(total // nseq, 1)),
            total_tokens=next_power_of_2(total),
            spec_tokens=next_power_of_2(spec_total) if spec_total else 0,
            tp=self.tp,
        )

    def _decode_profile(self, reqs: list[Request]) -> heuristics.BatchProfile:
        return heuristics.BatchProfile(
            num_seqs=len(reqs),
            max_context=next_power_of_2(max(r.total_len for r in reqs)),
            group=self._group, page_size=self.cfg.page_size,
            decode_share=1.0, avg_query_len=1,
            total_tokens=next_power_of_2(len(reqs)),
            tp=self.tp,
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
            tp=self.tp,
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
        if self.telemetry is not None:
            self.telemetry.record_dispatch(phase, kcfg.variant)
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
        on dead rows (temp 0 / top_p 1 / top_k 0 / stream 0 / drawn 0).
        The draw counter counts a pending placeholder: an in-flight token
        was drawn, and this launch's draw comes after it."""
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
            ngen[i] = r.num_generated + (1 if r._placeholder else 0)
        return temps, topp, topk, streams, ngen

    def _emit_token(self, r: Request, tok: int) -> None:
        """Deliver one sampled token: fill the pending placeholder (async)
        or append (sync), count the draw, record (req_id, token) for
        `stream()`."""
        if r._placeholder:
            r.output[-1] = tok
            r._placeholder = False
        else:
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
        self._note_drive_end("generate", steps, max_steps)
        return list(requests)

    def _note_drive_end(self, api: str, steps: int, max_steps: int) -> None:
        """Close a drive loop: its stats into `last_generate`, and a
        warning when the step budget ran out with requests unfinished
        (their outputs are truncated)."""
        unfinished = len(self.sched.waiting) + len(self.sched.running)
        exhausted = unfinished > 0 and steps >= max_steps
        self.last_generate = {"steps": steps, "unfinished": unfinished,
                              "exhausted": exhausted}
        if exhausted:
            log.warning("%s: max_steps=%d exhausted with %d request(s) not "
                        "FINISHED", api, max_steps, unfinished)

    def submit(self, req: Request) -> int:
        """Queue a request for the streaming loop; returns the req_id that
        `stream()` tags its tokens with."""
        self.add_request(req)
        return req.req_id

    def stream(self, *, max_steps: int = 10_000):
        """Drive the engine until the queue drains, yielding (req_id,
        token) pairs in emission order.  On the fused packed step the loop
        is double buffered: each iteration dispatches step N+1 before it
        blocks on step N's sampled ids.  The padded step, the two-dispatch
        step and a speculative engine (step N's accept counts decide step
        N+1's positions, contexts and pages) step synchronously, with the
        same yields."""
        steps = 0
        if not self._fused or self._spec:
            while self.sched.has_work and steps < max_steps:
                self.step()
                steps += 1
                yield from self._emitted
            self._note_drive_end("stream", steps, max_steps)
            return
        inflight: _Inflight | None = None
        while inflight is not None or \
                (self.sched.has_work and steps < max_steps):
            nxt = None
            if self.sched.has_work and \
                    steps + (1 if inflight is not None else 0) < max_steps:
                nxt = self._begin_step(inflight)
            if inflight is not None:
                self._finish_step(inflight)
                steps += 1
                yield from self._emitted
            inflight = nxt
        self._note_drive_end("stream", steps, max_steps)

    def run(self, *, max_steps: int = 10_000, on_token=None,
            on_finish=None) -> dict:
        """Drive `stream()` over everything `submit()`ted, calling
        `on_token(req_id, token)` for each sampled token and
        `on_finish(request)` as a request leaves the batch.  Returns
        {"outputs": {req_id: [token, ...]}} with the `last_generate`
        stats."""
        outputs: dict[int, list[int]] = {}
        prev_cb = self.sched.on_finish
        if on_finish is not None:
            def chained(req):
                if prev_cb is not None:
                    prev_cb(req)
                on_finish(req)
            self.sched.on_finish = chained
        try:
            for rid, tok in self.stream(max_steps=max_steps):
                outputs.setdefault(rid, []).append(tok)
                if on_token is not None:
                    on_token(rid, tok)
        finally:
            self.sched.on_finish = prev_cb
        return {"outputs": outputs, **self.last_generate}

    # ------------------------------------------------------------------
    # one engine step
    # ------------------------------------------------------------------

    def step(self) -> dict:
        tel = self.telemetry
        flight = self._schedule_and_pack(tel.clock.now() if tel else 0.0)
        if self._packed:
            return self._finish_step(flight)
        # the padded per-kind step: each launch samples its own rows
        self._emitted = []
        self._step_logits = []
        dec = flight.dec
        if dec.prefill_reqs:
            self._run_prefill(dec.prefill_reqs)
        if dec.decode_reqs:
            self._run_decode(dec.decode_reqs)
        if self._debug_logits and self._step_logits:
            self.last_step_logits = torch.cat(self._step_logits)
        # the configs its runners picked (the pack recorded none)
        flight.stats["dispatch"] = dict(self._last_dispatch)
        return self._finish_padded(flight)

    def _schedule_and_pack(self, t_step: float,
                           prev_rows: dict[int, int] | None = None,
                           prev_toks: torch.Tensor | None = None) \
            -> _Inflight:
        """The front half of a step, shared by `step()` and
        `_begin_step()`: schedule, account, update the page tables and, on
        the packed step, pack and DISPATCH, with no wait on the card.
        `t_step`: the step's start on the telemetry clock."""
        tel = self.telemetry
        self._last_dispatch = {}
        dec = self.sched.step(self.step_idx)
        if tel:
            tel.record_phase("schedule", t_step, tel.clock.now(),
                             decode=len(dec.decode_reqs),
                             prefill=len(dec.prefill_reqs))
        new_tokens = dec.scheduled_prefill_tokens
        # cached tokens count on a request's first chunk (the one starting
        # at the matched prefix); later chunks start past it
        cached_tokens = sum(r.num_cached_tokens for r in dec.prefill_reqs
                            if r.chunk_start == r.num_cached_tokens)
        self.prefilled_tokens += new_tokens
        self.cached_prefill_tokens += cached_tokens
        stats = {"prefill": len(dec.prefill_reqs),
                 "decode": len(dec.decode_reqs),
                 "preempted": len(dec.preempted),
                 "prefill_tokens": new_tokens,
                 "cached_tokens": cached_tokens,
                 "partial_prefills": sum(1 for r in dec.prefill_reqs
                                         if not r.prefill_done),
                 "budget_utilization": dec.budget_utilization}
        if self.prefix_cache is not None:
            stats.update(self.prefix_cache.stats())
        for req in dec.prefill_reqs:
            row = np.zeros((self.pages_per_seq,), np.int32)
            row[: len(req.pages)] = req.pages
            self.page_table[req.slot] = row
        for req in dec.decode_reqs:  # page growth
            row = self.page_table[req.slot]
            row[: len(req.pages)] = req.pages
        flight = _Inflight(dec=dec, stats=stats, t0=t_step)
        if self._packed and (dec.decode_reqs or dec.prefill_reqs):
            batch, flight.pack = self._pack_unified(
                dec.decode_reqs, dec.prefill_reqs, prev_rows=prev_rows)
            self._launch_unified(batch, flight, prev_toks)
        if self.prefix_cache is not None:
            for r in dec.prefill_reqs:
                # index the full pages written up to this chunk's end, so
                # a request admitted later reuses them, even mid-prefill
                # (the packed step set context_len at pack time; the
                # padded step sets it when its chunk has run, so it
                # indexes one step later, as the reference does)
                r.cache_cursor = self.prefix_cache.insert_incremental(
                    r.prompt, r.pages, r.context_len, r.cache_cursor)
        stats["dispatch"] = dict(self._last_dispatch)
        return flight

    def _begin_step(self, prev: _Inflight | None) -> _Inflight:
        """Schedule, pack and dispatch step N+1 while step N (`prev`) is
        still on the card.  A request with a sampling row in `prev` gets
        a PENDING_TOKEN placeholder, so every length, paging and
        max_new_tokens computation sees the state after step N; its
        decode row reads the token on the card from `prev`'s ids."""
        tel = self.telemetry
        t0 = tel.clock.now() if tel else 0.0
        prev_rows: dict[int, int] = {}
        if prev is not None and prev.pack is not None:
            for r, row, epoch in prev.pack.rows:
                if r._spec_epoch != epoch or \
                        r.state not in (State.RUNNING, State.PREFILLING):
                    continue
                prev_rows[r.req_id] = row
                if not r._placeholder:
                    r.output.append(PENDING_TOKEN)
                    r._placeholder = True
        flight = self._schedule_and_pack(
            t0, prev_rows=prev_rows,
            prev_toks=prev.toks if prev is not None else None)
        if tel and prev is not None and prev.pack is not None:
            # the host work above ran while the previous launch was still
            # on the card
            tel.record_phase("overlap", t0, tel.clock.now())
        return flight

    def _finish_step(self, flight: _Inflight) -> dict:
        """The back half of a packed step: wait for the launch's sampled
        ids, fold them into request state, then the step's epilogue."""
        tel = self.telemetry
        self._emitted = []
        self._step_spec = (0, 0, 0)
        if flight.pack is not None:
            if self._debug_logits:
                self.last_step_logits = flight.logits
            t_sample = tel.clock.now() if tel else 0.0
            toks = self._host_tokens(flight)
            if tel:
                tel.record_phase("sample", t_sample, tel.clock.now())
            self._consume_unified(flight.pack, toks)
        if self._spec:
            (flight.stats["spec_proposed"], flight.stats["spec_accepted"],
             flight.stats["spec_emitted"]) = self._step_spec
        return self._finish_padded(flight)

    def _finish_padded(self, flight: _Inflight) -> dict:
        """The epilogue of a step (on the padded step, its whole back
        half: its runners emitted their tokens): finishes, then stats.  A
        request whose last token is still in flight (an unfilled
        placeholder) finishes next step, once the token lands.  Then the
        step's telemetry, and the refit daemon's step boundary: a pending
        tree is swapped in here, between steps."""
        tel = self.telemetry
        stats = flight.stats
        t_host = tel.clock.now() if tel else 0.0
        for req in list(self.sched.running):
            if req.prefill_done and req.done and not req._placeholder:
                slot = req.slot  # finish() releases the slot
                self.sched.finish(req)
                if slot is not None:
                    self.page_table[slot] = 0
        stats["pool"] = self.alloc.mesh_stats(self.tp)
        stats["sampled_tokens"] = len(self._emitted)
        if tel:
            t_end = tel.clock.now()
            tel.record_phase("host", t_host, t_end)
            tel.record_step(t0=flight.t0, t1=t_end, decision=flight.dec,
                            stats=stats, engine=self)
        if self.refit is not None:  # hot-swap boundary (obs.refit)
            self.refit.on_step(self)
            stats["refit_swaps"] = self.refit.swaps
        self.step_idx += 1
        self.last_step_stats = stats
        return stats

    def _positions(self, pos: np.ndarray) -> np.ndarray:
        """A batch's positions: [1, T] / [B, S] as packed, or for "mrope"
        the same row in each of the three, [3, 1, T] / [3, B, S] (token
        ids only: t = h = w, as the reference's `_positions`)."""
        if self.cfg.rope_style != "mrope":
            return pos
        return np.ascontiguousarray(np.broadcast_to(pos[None],
                                                    (3,) + pos.shape))

    def _page_slots(self, row: np.ndarray, positions: np.ndarray) \
            -> np.ndarray:
        """Pool-local flat KV slots for in-sequence `positions` through one
        page-table row."""
        ps = self.cfg.page_size
        return row[positions // ps] * ps + positions % ps

    def _pack_unified(self, decode_reqs: list[Request],
                      prefill_reqs: list[Request],
                      prev_rows: dict[int, int] | None = None) \
            -> tuple[dict, _PackedLaunch]:
        """Build the batch for ONE token-packed launch.

        Rows [0, max_seqs) are the static decode region (decode rows
        sorted by pow2 context bucket, dead rows ctx = 0 with qlen = 1);
        prefill chunks (fresh, or resumed at context > 0) pack back to
        back behind it, the chunk-token count bucketed to a power of two
        (at least one page).  The sequence axis is static at 2 * max_seqs
        and the page table full-width.  Only decode rows and
        prompt-completing chunks sample.  `prev_rows` (async loop) maps
        req_id -> row of the launch still in flight whose sampled token is
        this request's decode input: `token_source` routes it from that
        launch's ids on the card (-1: the row's id is in `inputs`).

        A decode request with drafts (`spec_tokens`) leaves the decode
        region: it packs behind the prefill chunks, context-bucket
        sorted, as a resumed chunk [last real token, draft_1..draft_s] at
        positions total_len - 1.. with context total_len + s, so each
        draft attends its predecessors; `spec_lens` carries s.  Each
        request's `context_len` advances here; a spec row's to the
        minimum its launch surely writes (total_len), which
        `_consume_unified` finalizes."""
        tel = self.telemetry
        t_pack = tel.clock.now() if tel else 0.0
        ms = self.max_seqs
        ps = self.cfg.page_size
        bucket = lambda r: next_power_of_2(max(r.total_len, 1))  # noqa: E731
        plain = sorted((r for r in decode_reqs if not r.spec_tokens),
                       key=bucket)
        spec_reqs = sorted((r for r in decode_reqs if r.spec_tokens),
                           key=bucket)
        if len(prefill_reqs) + len(spec_reqs) > ms:
            raise RuntimeError("chunk region overflow: more chunks and "
                               "spec rows than max_seqs")
        spec_total = sum(len(r.spec_tokens) for r in spec_reqs)
        profile = self._unified_profile(decode_reqs, prefill_reqs,
                                        spec_total=spec_total)
        n_pref = sum(r.num_scheduled_tokens for r in prefill_reqs) \
            + spec_total + len(spec_reqs)
        t = ms + (max(next_power_of_2(n_pref), ps) if n_pref else 0)
        s = 2 * ms
        np_b = self.pages_per_seq
        trash = self.num_pages * ps  # out-of-range slot: writes dropped

        tokens = np.zeros((1, t), np.int64)
        pos = np.zeros((1, t), np.int64)
        slots = np.full((1, t), trash, np.int64)
        src = np.full((1, t), -1, np.int32)
        qlens = np.zeros((s,), np.int32)
        ctx = np.zeros((s,), np.int32)
        pt = np.zeros((s, np_b), np.int32)
        qsl = np.full((s + 1,), ms, np.int32)
        qsl[:ms + 1] = np.arange(ms + 1)
        qlens[:ms] = 1  # dead decode rows are masked by ctx == 0
        rows: list[tuple[Request, int, int]] = []
        spec_lens = np.zeros((s,), np.int32)
        for i, r in enumerate(plain):
            if prev_rows and r.req_id in prev_rows:
                src[0, i] = prev_rows[r.req_id]  # in flight: on the card
            elif r._placeholder:
                raise RuntimeError(f"request {r.req_id}: decode input still "
                                   "in flight")
            else:
                tokens[0, i] = r.output[-1] if r.output else r.prompt[-1]
            p = r.total_len - 1
            pos[0, i] = p
            ctx[i] = r.total_len
            row = self.page_table[r.slot]
            pt[i] = row[:np_b]
            slots[0, i] = self._page_slots(row, np.asarray(p))
            rows.append((r, i, r._spec_epoch))
            r.context_len = r.total_len
        cur = ms
        for j, r in enumerate(prefill_reqs + spec_reqs):
            i = ms + j
            if r.spec_tokens:  # a verify row: consumes its drafts
                drafts, r.spec_tokens = r.spec_tokens, []
                n = len(drafts) + 1
                last = r.output[-1] if r.output else r.prompt[-1]
                tokens[0, cur: cur + n] = [last] + drafts
                p = np.arange(r.total_len - 1, r.total_len - 1 + n,
                              dtype=np.int64)
                ctx[i] = r.total_len - 1 + n
                spec_lens[i] = n - 1
                rows.append((r, i, r._spec_epoch))
                r.context_len = r.total_len
            else:
                n = r.num_scheduled_tokens
                tokens[0, cur: cur + n] = \
                    r.prompt[r.chunk_start: r.chunk_start + n]
                p = np.arange(r.chunk_start, r.chunk_start + n,
                              dtype=np.int64)
                ctx[i] = r.chunk_start + n
                if r.chunk_start + n == r.num_prompt_tokens:
                    rows.append((r, i, r._spec_epoch))  # completing: samples
                r.context_len = r.chunk_start + n
            pos[0, cur: cur + n] = p  # packed-position RoPE: absolute
            qlens[i] = n
            row = self.page_table[r.slot]
            pt[i] = row[:np_b]
            slots[0, cur: cur + n] = self._page_slots(row, p)
            cur += n
            qsl[i + 1:] = cur

        kcfg = self._dispatch("unified", profile)
        rows_sampling = self._sampling_rows(s, [(i, r) for r, i, _ in rows])
        pack = _PackedLaunch(rows=rows, prefill_reqs=list(prefill_reqs),
                             profile=profile, kcfg=kcfg, tokens=t,
                             sampling=rows_sampling, spec_lens=spec_lens)
        batch = {"inputs": tokens, "positions": self._positions(pos),
                 "page_table": pt,
                 "context_lens": ctx, "query_lens": qlens,
                 "query_start_loc": qsl, "slot_mapping": slots,
                 "token_source": src}
        if self._fused:
            temps, topp, topk, _, _ = rows_sampling
            batch.update(temperature=temps, top_p=topp, top_k=topk)
        if self._spec:
            batch["spec_lens"] = spec_lens
        if tel:
            tel.record_phase("pack", t_pack, tel.clock.now(), tokens=t)
        return batch, pack

    def _draw_noise(self, pack: _PackedLaunch) -> None:
        """The sampler's host part: each sampling row's Gumbel noise,
        seeded from (seed, stream id, tokens drawn), into the static
        buffer (zeroed where no row samples; untouched while it stays all
        zero); on a spec engine each verify position's, at its own
        counter (`sampling.verify_rows`).  It only queues work on the
        stream: the launch in flight reads the buffer before these writes
        run."""
        temps, _, _, streams, ngen = pack.sampling
        if self._spec:
            streams, ngen, hot = sampling.verify_rows(
                temps, streams, ngen, pack.spec_lens, self.max_draft)
        else:
            hot = sampling.hot_rows(temps)
        if hot or self._noisy:
            sampling.gumbel_noise(self.seed, streams, ngen,
                                  self.cfg.vocab_size, self.device, rows=hot,
                                  out=self._noise)
        self._noisy = bool(hot)

    def _launch_unified(self, batch: dict, flight: _Inflight,
                        prev_toks: torch.Tensor | None) -> None:
        """Dispatch one packed launch through the executable cache and
        queue the copy of its sampled ids to the host, without waiting
        for either: `flight` gets the device ids (the next launch's
        `prev_tokens`), the host buffer they are copied into, and the
        debug logits.  `prev_toks`: the ids of the launch in flight, if
        any (else zeros; no row reads them then)."""
        tel = self.telemetry
        pack = flight.pack
        pre = len(self.compile_events)
        key = ("unified", 2 * self.max_seqs, pack.tokens, pack.kcfg)
        fn = self._get_fn(*key)
        self.device_calls["unified"] += 1
        prev = self._no_prev if prev_toks is None else prev_toks
        if self._fused:
            self._draw_noise(pack)
        t_launch = tel.clock.now() if tel else 0.0
        with self._launch_ctx("unified"):
            out = fn(batch, {"prev_tokens": prev})
        if tel:
            self._record_launch("unified", key, pack.profile, pack.kcfg,
                                t_launch, out[0], pre, tokens=pack.tokens,
                                grid_phase="unified")
        if not self._fused:  # the two-dispatch step samples at the finish
            logits, = out
            flight.logits = logits.clone() if self._debug_logits else logits
            self.launched_token_slots += pack.tokens
            return
        toks, logits = out
        flight.toks = toks
        flight.host = self._copies.start(toks)
        if self._debug_logits:  # a copy: a replay overwrites the buffer
            flight.logits = logits.clone()
        self.launched_token_slots += pack.tokens

    def _host_tokens(self, flight: _Inflight):
        """The flight's sampled ids on the host: [S] (waiting for their
        copy), ([S, K+1] tokens, [S] accept counts) on a spec engine.  On
        the two-dispatch step the second dispatch samples the launch's
        logits here (the step is synchronous: no later launch has
        overwritten them)."""
        if not self._fused:
            return self._sample(flight.logits, flight.pack.sampling)
        ids = self._copies.wait(flight.host)
        if self._spec:
            return ids[:, :-1], ids[:, -1]
        return ids

    def _consume_unified(self, pack: _PackedLaunch, toks) -> None:
        """Fold one launch's sampled tokens back into request state.  Rows
        whose request finished, or was preempted, while the launch was in
        flight are discarded by state and epoch.

        A spec launch's row emits its accepted drafts and the bonus /
        correction token (stopping at EOS or max_new_tokens), then rolls
        back exactly: `context_len` covers the kept tokens only (the KV
        past it is never read and is rewritten later; the bonus token's KV
        is written next step, as a plain decode's), and the pages grown
        for the drafts past the new total_len go back to the pool.  Those
        are always this step's fresh refcount-1 pages (the scheduler grew
        them past the covered total_len), so rollback never frees a
        shared or cached page."""
        tel = self.telemetry
        emitted = None
        if self._spec:
            toks, emitted = toks
        proposed = accepted = spec_emitted = spec_rows = 0
        for r, row, epoch in pack.rows:
            if r.state is State.FINISHED or r._spec_epoch != epoch:
                continue
            if not self._spec:
                self._emit_token(r, int(toks[row]))
                if tel:
                    tel.requests.token(r)
                continue
            k = int(pack.spec_lens[row])
            kept = 0
            for j in range(min(int(emitted[row]), k + 1)):
                self._emit_token(r, int(toks[row, j]))
                kept += 1
                if tel:
                    tel.requests.token(r)
                if r.done:
                    break
            if k:
                r.context_len = r.total_len - 1
                target = self.alloc.pages_needed(r.total_len)
                if len(r.pages) > target:
                    self.alloc.free(r.pages[target:])
                    del r.pages[target:]
                spec_rows += 1
                proposed += k
                accepted += kept - 1
                spec_emitted += kept
                self.drafter.observe(k, kept - 1)
        if self._spec:
            self._step_spec = (proposed, accepted, spec_emitted)
            self.spec_stats["proposed"] += proposed
            self.spec_stats["accepted"] += accepted
            self.spec_stats["emitted"] += spec_emitted
            if spec_rows:
                self.spec_stats["steps"] += 1
        if tel:
            for r in pack.prefill_reqs:
                if r.state in (State.PREFILLING, State.RUNNING):
                    tel.requests.chunk(r)

    # ------------------------------------------------------------------
    # the padded per-kind step
    # ------------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, rows: tuple) -> np.ndarray:
        """The separate sampling dispatch (the padded step's, the
        two-dispatch packed step's): the same per-request-stream draw as
        the fused sampler over `_sampling_rows` arrays; host ids [n]."""
        self.device_calls["sample"] += 1
        return sampling.sample_rows(logits, self.seed, *rows).cpu().numpy()

    def _finish_chunk(self, reqs: list[Request], logits: torch.Tensor) \
            -> None:
        """Advance progress; sample first tokens for prompts now complete."""
        tel = self.telemetry
        done = [(i, r) for i, r in enumerate(reqs)
                if r.chunk_start + r.num_scheduled_tokens
                == r.num_prompt_tokens]
        if done:
            t_sample = tel.clock.now() if tel else 0.0
            toks = self._sample(
                logits, self._sampling_rows(logits.shape[0], done))
            for i, r in done:
                self._emit_token(r, int(toks[i]))
            if tel:
                tel.record_phase("sample", t_sample, tel.clock.now())
        for r in reqs:
            r.context_len = r.chunk_start + r.num_scheduled_tokens
        if tel:
            done_ids = {r.req_id for _, r in done}
            for r in reqs:
                tel.requests.chunk(r)
                if r.req_id in done_ids:
                    tel.requests.token(r)

    def _run_prefill(self, reqs: list[Request]) -> None:
        """One scheduled chunk per request: chunks at context 0 (a fresh
        prompt, or the first chunk of a chunked one) run the uniform
        prefill; chunks at context > 0 (after earlier chunks, a prefix
        cache hit, or both) run the resumed prefill over a page table
        narrowed to the width bucket `np_b` the longest context needs."""
        fresh = [r for r in reqs if r.chunk_start == 0]
        resumed = [r for r in reqs if r.chunk_start > 0]
        if fresh:
            self._run_prefill_padded(fresh, "prefill", self.pages_per_seq)
        if resumed:
            max_ctx = max(r.chunk_start + r.num_scheduled_tokens
                          for r in resumed)
            np_b = min(self.pages_per_seq,
                       next_power_of_2(cdiv(max_ctx, self.cfg.page_size)))
            self._run_prefill_padded(resumed, "prefill_cached", np_b)

    def _run_prefill_padded(self, reqs: list[Request], phase: str,
                            np_b: int) -> None:
        """The padded prefill of one scheduled chunk per request, [pow2
        batch, pow2 seq], at absolute positions: only the chunk is
        embedded and computed; attention reads any prior context back
        from the pages (context_lens = chunk_start + chunk).  Entry
        ("prefill", b, s, kcfg) for chunks at context 0,
        ("prefill_cached/np{np_b}", b, s, kcfg) for resumed ones.  Its
        key is recorded in `compile_events`, but the entry stays eager,
        also on the card (each bucket recurs rarely, so a capture would
        seldom pay back)."""
        tel = self.telemetry
        t_pack = tel.clock.now() if tel else 0.0
        b = next_power_of_2(len(reqs))
        max_chunk = max(r.num_scheduled_tokens for r in reqs)
        s = max(next_power_of_2(max_chunk), self.cfg.page_size)
        tokens = np.zeros((b, s), np.int64)
        qlens = np.zeros((b,), np.int32)
        ctx = np.zeros((b,), np.int32)
        pt = np.zeros((b, np_b), np.int32)
        pos = np.tile(np.arange(s, dtype=np.int64)[None], (b, 1))
        for i, r in enumerate(reqs):
            n = r.num_scheduled_tokens
            tokens[i, :n] = r.prompt[r.chunk_start: r.chunk_start + n]
            qlens[i] = n
            ctx[i] = r.chunk_start + n
            pos[i] += r.chunk_start
            pt[i] = self.page_table[r.slot][:np_b]
        profile = self._prefill_profile(reqs)
        kcfg = self._dispatch(phase, profile)
        kind = phase if phase == "prefill" else f"{phase}/np{np_b}"
        pre = len(self.compile_events)
        key = (kind, b, s, kcfg)
        fn = self._get_fn(*key)
        self.device_calls[phase] += 1
        batch = {"inputs": tokens, "positions": self._positions(pos),
                 "page_table": pt, "context_lens": ctx, "query_lens": qlens}
        if tel:
            t_launch = tel.clock.now()
            tel.record_phase("pack", t_pack, t_launch, tokens=b * s)
        with self._launch_ctx(phase):
            logits, new_cache = fn(batch)
        if tel:
            self._record_launch(phase, key, profile, kcfg, t_launch, logits,
                                pre, tokens=b * s, grid_phase="prefill")
        if self._debug_logits:
            self._step_logits.append(logits)
        self.launched_token_slots += b * s
        # merge the recurrent rows back, sample the prompts it completes
        self._merge_prefill_cache(new_cache, [r.slot for r in reqs])
        self._finish_chunk(reqs, logits)

    def _run_decode(self, reqs: list[Request]) -> None:
        tel = self.telemetry
        t_pack = tel.clock.now() if tel else 0.0
        b = self.max_seqs  # static decode batch (paper C5)
        tokens = np.zeros((b, 1), np.int64)
        pos = np.full((b, 1), -1, np.int64)
        ctx = np.zeros((b,), np.int32)
        for r in reqs:
            tokens[r.slot, 0] = r.output[-1] if r.output else r.prompt[-1]
            pos[r.slot, 0] = r.total_len - 1
            ctx[r.slot] = r.total_len
        profile = self._decode_profile(reqs)
        kcfg = self._dispatch("decode", profile)
        pre = len(self.compile_events)
        key = ("decode", b, 1, kcfg)
        fn = self._get_fn(*key)
        self.device_calls["decode"] += 1
        batch = {"inputs": tokens, "positions": self._positions(pos),
                 "page_table": self.page_table.copy(), "context_lens": ctx}
        if tel:
            t_launch = tel.clock.now()
            tel.record_phase("pack", t_pack, t_launch, tokens=b)
        with self._launch_ctx("decode"):
            logits, = fn(batch)
        if tel:
            self._record_launch("decode", key, profile, kcfg, t_launch,
                                logits, pre, tokens=b)
        if self._debug_logits:  # a copy: a replay overwrites the buffer
            self._step_logits.append(logits.clone())
        self.launched_token_slots += b
        t_sample = tel.clock.now() if tel else 0.0
        toks = self._sample(
            logits, self._sampling_rows(b, [(r.slot, r) for r in reqs]))
        if tel:
            tel.record_phase("sample", t_sample, tel.clock.now())
        for r in reqs:
            r.context_len = r.total_len
            self._emit_token(r, int(toks[r.slot]))
            if tel:
                tel.requests.token(r)

    # ------------------------------------------------------------------
    # slot-indexed (SSM) cache plumbing
    # ------------------------------------------------------------------

    def _prefill_cache_view(self, b: int) -> dict:
        """The attention pages (where the model has any) are global; the
        recurrent rows of a prefill start from the empty state, zeros with
        the mLSTM / sLSTM stabilisers `m` at -inf, as `M.make_cache` makes
        them (a hybrid or ssm prefill always begins at context 0: chunked
        prefill and prefix caching are dense only)."""
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
