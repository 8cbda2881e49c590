"""Kernel-config heuristics — the paper's §5 'autotuning exported as simple
if/else decision trees' (Listing 2), adapted to the TPU tuning surface:
kernel variant (C1/C2/C3), KV tile size (C4), segment count (C3), and the
prefill Q-block size (C2).

The default trees below mirror the paper's shipped heuristic structure; the
autotune subsystem (repro.autotune) regenerates them from microbenchmark
sweeps and `load()` swaps them in (one tree per phase: decode launches and
prefill launches are separate executables with separate tuning surfaces).
Decisions happen at *dispatch* time on host-side batch metadata — never
inside the compiled graph — which is exactly what keeps them compatible
with the static-shape (CUDA-graph-analog) executables (paper §6.2): the
engine keys each compiled program by (batch-bucket, seq-bucket,
KernelConfig), so a tree that flips variants by batch shape replays cached
graphs instead of recompiling.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    variant: str  # 'baseline' | 'gqa' | 'segmented'
    tile: int | None = None  # None -> ops.default_tile(page_size)
    num_segments: int = 8
    block_q: int = 16  # prefill Q-block tokens


@dataclasses.dataclass(frozen=True)
class BatchProfile:
    """Host-side batch metadata the tree branches on (paper §6.1).
    `total_tokens` and `decode_share` describe the PACKED batch mix for
    the unified launch (decode rows + chunk tokens in one stream); the
    per-phase trees ignore them."""
    num_seqs: int
    max_context: int
    group: int  # q heads per kv head
    page_size: int
    decode_share: float = 1.0  # fraction of decode requests in the batch
    avg_query_len: int = 1
    total_tokens: int = 0  # packed token-stream length (0: per-phase launch)
    # speculative-decoding dimension: pow2-bucketed count of draft tokens
    # verified in the launch (0: non-speculative).  Spec steps stretch
    # decode rows into short resumed chunks, a distinct shape the tuned
    # trees can split on.
    spec_tokens: int = 0
    # mesh fingerprint: tuned trees are keyed per (arch, tp) — a tp-split
    # head axis changes per-device arithmetic intensity, so a tree fit at
    # tp=1 must not silently steer a tp=4 deployment (PAPERS.md:
    # portability needs re-autotuning per deployment shape).  LAST field:
    # telemetry serializes profiles with dataclasses.astuple.
    tp: int = 1


_DECODE_TREE: list[tuple[dict, KernelConfig]] | None = None
_PREFILL_TREE: list[tuple[dict, KernelConfig]] | None = None
_UNIFIED_TREE: list[tuple[dict, KernelConfig]] | None = None
_SUGGESTED_CHUNK: int | None = None
_LOADED_PATH: str | None = None
_ENV_CHECKED = False


def default_decode_config(p: BatchProfile) -> KernelConfig:
    """Default decision tree (pre-autotune). Structure follows paper §4.5:
    segmented (parallel tiled softmax) only for small batches of long
    sequences; otherwise the GQA Q-Block kernel; tiles sized to the page."""
    if p.num_seqs * p.group >= 64 or p.max_context <= 2 * p.page_size:
        return KernelConfig("gqa")
    # small batch, long context -> extract parallelism across segments
    segs = max(2, min(16, p.max_context // (8 * p.page_size)))
    return KernelConfig("segmented", num_segments=segs)


def default_prefill_config(p: BatchProfile) -> KernelConfig:
    # paper Listing 2: bigger Q blocks for long prompts
    bq = 32 if p.avg_query_len >= 4096 else 16
    return KernelConfig("gqa", block_q=bq)


def default_unified_config(p: BatchProfile) -> KernelConfig:
    """Default tree for the token-packed unified launch: the decode
    region picks its variant like the decode tree (segmented only helps
    decode-dominated small batches of long sequences), the chunk region
    its Q-block like the prefill tree."""
    bq = 32 if p.avg_query_len >= 4096 else 16
    if p.decode_share >= 0.5 and p.num_seqs * p.group < 64 \
            and p.max_context > 2 * p.page_size:
        segs = max(2, min(16, p.max_context // (8 * p.page_size)))
        return KernelConfig("segmented", num_segments=segs, block_q=bq)
    return KernelConfig("gqa", block_q=bq)


def _match(cond: dict, p: BatchProfile) -> bool:
    ok = True
    for key, bound in cond.items():
        field, op = key.rsplit("_", 1)
        val = getattr(p, field)
        ok &= val <= bound if op == "le" else val >= bound
    return ok


def decode_config(p: BatchProfile) -> KernelConfig:
    if _DECODE_TREE is not None:
        for cond, cfg in _DECODE_TREE:
            if _match(cond, p):
                return cfg
    return default_decode_config(p)


def prefill_config(p: BatchProfile) -> KernelConfig:
    if _PREFILL_TREE is not None:
        for cond, cfg in _PREFILL_TREE:
            if _match(cond, p):
                return cfg
    return default_prefill_config(p)


def unified_config(p: BatchProfile) -> KernelConfig:
    if _UNIFIED_TREE is not None:
        for cond, cfg in _UNIFIED_TREE:
            if _match(cond, p):
                return cfg
    return default_unified_config(p)


def validate(cfg: KernelConfig, page_size: int) -> KernelConfig:
    """Clamp a (possibly foreign-arch) tuned config to this cache geometry:
    the Pallas tile view requires tile | page_size. Invalid tiles fall back
    to the ops-level default rather than crashing dispatch."""
    if cfg.tile is not None and (cfg.tile > page_size
                                 or page_size % cfg.tile):
        return dataclasses.replace(cfg, tile=None)
    return cfg


def _parse_tree(raw_tree) -> list[tuple[dict, KernelConfig]]:
    return [(cond, KernelConfig(**cfg)) for cond, cfg in raw_tree]


def load_payload(raw: dict, source: str = "<payload>") -> None:
    """Install decision trees from an in-memory payload dict — the hot-
    swap half of the online refit loop (`obs.refit.RefitDaemon`), and the
    body of the file-backed `load()`.  Safe to call between engine steps:
    dispatch re-reads the module globals at every step's pack, and the
    parse-everything-first discipline keeps a malformed payload from
    leaving a half-installed tree behind."""
    global _DECODE_TREE, _PREFILL_TREE, _UNIFIED_TREE, _SUGGESTED_CHUNK, \
        _LOADED_PATH
    decode_tree = _parse_tree(raw["decode_tree"])
    prefill_tree = (_parse_tree(raw["prefill_tree"])
                    if raw.get("prefill_tree") else None)
    unified_tree = (_parse_tree(raw["unified_tree"])
                    if raw.get("unified_tree") else None)
    _DECODE_TREE = decode_tree
    _PREFILL_TREE = prefill_tree
    _UNIFIED_TREE = unified_tree
    _SUGGESTED_CHUNK = raw.get("suggested_max_prefill_tokens")
    _LOADED_PATH = source
    log.info("attention heuristics loaded from %s (%d decode leaves, "
             "%d prefill leaves, %d unified leaves)", source,
             len(_DECODE_TREE), len(_PREFILL_TREE or ()),
             len(_UNIFIED_TREE or ()))


def load(path: str) -> None:
    """Install autotune-exported decision trees (JSON: first-match-wins
    [condition, kernel_config] lists under 'decode_tree' / 'prefill_tree',
    plus an optional roofline-derived 'suggested_max_prefill_tokens')."""
    with open(path) as f:
        raw = json.load(f)
    load_payload(raw, source=path)


def loaded_path() -> str | None:
    return _LOADED_PATH


def suggested_max_prefill_tokens() -> int | None:
    """Chunk-size budget exported by the cost-model roofline autotuner
    (None when no tree is loaded or the export predates the field)."""
    return _SUGGESTED_CHUNK


def reset() -> None:
    global _DECODE_TREE, _PREFILL_TREE, _UNIFIED_TREE, _SUGGESTED_CHUNK, \
        _LOADED_PATH, _ENV_CHECKED
    _DECODE_TREE = None
    _PREFILL_TREE = None
    _UNIFIED_TREE = None
    _SUGGESTED_CHUNK = None
    _LOADED_PATH = None
    _ENV_CHECKED = False


def maybe_load_env() -> str | None:
    """Install the tree named by $REPRO_ATTN_HEURISTICS (if any). Called at
    engine init; idempotent so repeated engine constructions don't re-read
    the file, and an EXPLICITLY loaded tree (`load()` / `--heuristics`)
    always wins over the environment. Returns the loaded path (new or
    previous) or None."""
    global _ENV_CHECKED
    if _ENV_CHECKED or _LOADED_PATH is not None:
        return _LOADED_PATH
    _ENV_CHECKED = True
    path = os.environ.get("REPRO_ATTN_HEURISTICS", "")
    if path and os.path.exists(path):
        load(path)
        return path
    if path:
        log.warning("REPRO_ATTN_HEURISTICS=%s does not exist; "
                    "using default heuristics", path)
    return None
