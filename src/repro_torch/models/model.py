"""Decoder models: the dense and MoE families, the hybrid family (zamba2)
and the ssm family (xlstm), their serving steps and their training
loss.

Dense `Model`: embed -> L decoder blocks (RMSNorm, GQA attention, RMSNorm,
SwiGLU MLP, both residual) -> `ln_f` -> head (tied to the embedding for
smollm).  The audio (musicgen-large: no position encoding) and vlm
(qwen2-vl-2b: M-RoPE over [3, B, S] t / h / w positions) families are
this dense decoder, as in the reference; they take [B, S, d] embedding
inputs where the reference does (`_embed`) and decode token
ids.  Any block may hold the fused `wqkv` / `gate_up` layouts.  MoE
`Model` (family "moe", llama4-maverick): the same stack,
`first_k_dense` leading dense blocks (`lead_blocks`) then blocks whose
FFN is the `MoE` (`models/moe.py`: dropless when serving, the capacity
dispatch in training), -> `ln_f` -> the untied `lm_head`.  deepseek-v2
is a MoE model whose blocks hold MLA (`MLAAttention`) in place of GQA;
it serves on the padded step only, as in the reference.  Hybrid `Model`
(family "hybrid", zamba2): embed ->
[(period-1) Mamba2 blocks, then the ONE weight-shared decoder block] x
n_attn, then the tail Mamba2 blocks (`hybrid_layout`) -> `ln_f` -> the
untied `lm_head`.  Each Mamba2 block is pre-normed (`mamba_ln`) and
residual.  SSM `Model` (family "ssm", xlstm): embed -> [(period-1) mLSTM
blocks, then one sLSTM block] x n_slstm, then the tail mLSTM blocks
(`xlstm_layout`) -> `ln_f` -> the untied `lm_head`; every block is
pre-normed (`mlstm_ln`, `slstm_ln`) and residual, and no layer holds KV
pages.

Entry points (ports of `repro.models.model`):

  apply_unified  token-packed decode + prefill chunks over the paged cache,
                 last-token gather and fused sampling, and the
                 speculative verify epilogue (dense and moe)
  apply_prefill  padded [B, S] fresh prompts at context 0 (every family)
  apply_prefill_cached  padded [B, S] chunks resumed after a prior
                 context in the pages (dense and moe)
  apply_decode   padded [B, 1] decode batch (every family)
  apply_train    causal attention and the recurrent scans over whole
                 sequences, the reference's blocks rematerialised in the
                 backward, masked fp32 CE plus the MoE blocks'
                 load-balance aux (every family; MoE blocks on the
                 capacity dispatch, MLA in its expanded form, the SSD and
                 mLSTM on their kernels with the recompute backward)

Under a mesh's rules (`sharding.use_rules`; the dry run's cells) the
padded serving entries take this rank's batch rows and its block of the
cache (`param_sharding.assign_cache_shardings`): the embedding is looked
up vocabulary-parallel, each block computes on the rank's heads (and
its experts, or its block of the ff axis) and closes with its
all-reduce over 'model', and the logits are the rank's block of the
vocabulary, as the reference's vocab-sharded logits.

The serving cache (`make_cache`) is the reference's tree: {"attn":
{"k_pages", "v_pages"}} for the attention layers (none for xlstm; MLA's
is {"k_pages"} alone, its [latent | k_rope] rows), for
the hybrid family {"mamba": {"conv", "ssm"}}, and for the ssm family
{"mlstm": {"conv", "c", "n", "m"}, "slstm": {"h", "c", "n", "m"}}, the
recurrent leaves indexed by [layer, slot].  The serving steps write it
IN PLACE and return it, as the reference returns its new cache.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged.kv_cache import (
    make_kv_cache, physical_slots, write_index,
)
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    checkpoint_contexts, constrain, expert_group, resolve, spec,
)
from repro_torch.kernels.layer_glue import kernel as GL
from repro_torch.kernels.layer_glue import ops as glue_ops
from repro_torch.models import layers as L
from repro_torch.models import sampling
from repro_torch.models.attention import (Attention, MLAAttention,
                                          kv_cache_dims, residual, temporal)
from repro_torch.models.moe import MoE, moe_ffn_dropless_ep
from repro_torch.models.ssm_blocks import (
    Mamba2Block, MLSTMBlock, SLSTMBlock, mamba2_cache_specs,
    mlstm_cache_specs, slstm_cache_specs,
)


def residual_layout(b: int, s: int, d: int) -> tuple:
    """On a training mesh: the layout of the residual stream [b, S, d] of
    this rank's b batch rows (`constrain(x, "batch", "seq_sp", "embed")`:
    the sequence on 'model' under sequence parallelism where it
    divides)."""
    batch = spec("batch")[0]
    return resolve((b * spmd.axes_size(batch), s, d), "batch", "seq_sp",
                   "embed")


def whole_seq(x: torch.Tensor, s: int) -> torch.Tensor:
    """This rank's batch rows of the residual stream over the whole
    sequence of length s (an all-gather on 'model' under sequence
    parallelism)."""
    held = residual_layout(x.shape[0], s, x.shape[-1])
    return constrain(x, "batch", "seq", "embed", held=held)


class Block(nn.Module):
    """A decoder block; its FFN is the SwiGLU `mlp`, or with `use_moe` the
    dropless `moe` in its place (the reference's `_init_decoder_block`)."""

    def __init__(self, cfg: ModelConfig, *, use_moe: bool = False,
                 device=None):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=dt,
                             device=device)
        self.attn = (MLAAttention if cfg.mla.kv_lora_rank else Attention)(
            cfg, device=device)
        self.ln2 = L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=dt,
                             device=device)
        if use_moe:
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype=dt, device=device,
                             fused=cfg.fused_mlp)

    def ffn(self, x: torch.Tensor, packed: bool = False) -> torch.Tensor:
        """The serving FFN: the MLP, or the MoE's dropless path; that path
        expert-parallel over the active expert group
        (`sharding.use_expert_group`) where the config sets
        `moe_ep_serve`, as the reference's `_decoder_block`.  Under a
        mesh's rules (`sharding.use_rules`) the MLP runs tensor-parallel
        on the ff axis and the MoE on this rank's experts
        (`moe_ffn_dropless_mesh`); without them each is whole.  `packed`
        (the packed step, never under the rules): the MLP, and the MoE's
        shared experts, take the SwiGLU gate kernel (`MLP.forward_serve`)."""
        if hasattr(self, "moe"):
            group = expert_group()
            if self.moe.ep_serve and group is not None:
                return moe_ffn_dropless_ep(self.moe, x, group, packed)[0]
            return self.moe(x, packed=packed)[0]
        if packed:
            return self.mlp.forward_serve(x)
        return residual(*self.mlp.forward_partial(x))

    def forward_train(self, x: torch.Tensor, positions: torch.Tensor):
        """(x after the block, the MoE's load-balance aux fp32 0-d, or
        None for a dense block).  On a training mesh x is this rank's block
        of the residual stream's layout (`residual_layout`): each norm runs
        on its rows, whose sequence is all-gathered for attention and the
        FFN, whose outputs return to the layout (reduce-scattered where
        they are pending sums over 'model').  Without a mesh each of these
        moves is the identity."""
        s = positions.shape[-1]
        x = x + self.attn.forward_train(whole_seq(self.ln1(x), s),
                                        positions)
        h = whole_seq(self.ln2(x), s)
        if hasattr(self, "moe"):
            y, aux = self.moe(h, mode="train")
            return x + residual(y, False), aux
        return x + residual(*self.mlp.forward_partial(h)), None

    def forward_serve(self, x: torch.Tensor, positions: torch.Tensor,
                      k_pages: torch.Tensor, v_pages: torch.Tensor | None,
                      meta: dict, *, mode: str,
                      kernel_cfg=None) -> torch.Tensor:
        """Padded serving mode "prefill", "prefill_cached" or "decode"
        over this layer's pages [Hkv, 1, P, ps, D] (written in place;
        v_pages None for MLA)."""
        attn = (self.attn.forward_decode if mode == "decode"
                else self.attn.forward_prefill)
        x = x + attn(self.ln1(x), positions, k_pages, v_pages, meta,
                     kernel_cfg=kernel_cfg)
        return x + self.ffn(self.ln2(x))


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """zamba2: every `shared_attn_period`-th block is the shared attention
    block.  (n_mamba, n_attn, group) with the layout
    [(period-1) mamba + 1 shared attention] * n_attn + tail mamba."""
    period = cfg.ssm.shared_attn_period
    n_attn = cfg.num_layers // period
    return cfg.num_layers - n_attn, n_attn, period - 1


def xlstm_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """xlstm: every `slstm_period`-th block is an sLSTM block.  (n_mlstm,
    n_slstm, group) with the layout [(period-1) mLSTM + 1 sLSTM] *
    n_slstm + tail mLSTM."""
    period = cfg.ssm.slstm_period
    n_s = cfg.num_layers // period
    return cfg.num_layers - n_s, n_s, period - 1


def stack_order(n_rec: int, n_mid: int, group: int):
    """The layer order of a `hybrid_layout` / `xlstm_layout` stack:
    ("rec", i) for the i-th recurrent layer (Mamba2 / mLSTM) and ("mid",
    g) for the g-th layer between groups (the shared block's g-th use /
    the g-th sLSTM): [group rec + 1 mid] * n_mid, then the tail of rec."""
    for g in range(n_mid):
        for i in range(g * group, (g + 1) * group):
            yield "rec", i
        yield "mid", g
    for i in range(n_mid * group, n_rec):
        yield "rec", i


# the families whose model is the decoder stack of `Block`s: the audio
# (musicgen) and vlm (qwen2-vl) backbones are the dense decoder, as in the
# reference
DECODER_FAMILIES = ("dense", "moe", "audio", "vlm")


def moe_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(leading dense blocks, the blocks after them): `first_k_dense`
    leading blocks keep the SwiGLU MLP in a MoE model."""
    lead = cfg.moe.first_k_dense if cfg.moe.num_experts else 0
    return lead, cfg.num_layers - lead


def attn_layer_count(cfg: ModelConfig) -> int:
    """Layers that hold KV pages: each shared-block invocation of a hybrid
    has its own; xlstm has none."""
    if cfg.family == "hybrid":
        return hybrid_layout(cfg)[1]
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers


class Model(nn.Module):
    """Dense decoder (families "dense", "audio" and "vlm"), MoE decoder
    (family "moe"), zamba2 hybrid (family "hybrid") or xlstm (family
    "ssm").  Parameters are allocated empty: fill them with
    `weights.from_jax_params` or `weights.init_random`."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family not in DECODER_FAMILIES + ("hybrid", "ssm"):
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=dt, device=device),
            requires_grad=False)
        if cfg.family in DECODER_FAMILIES:
            lead, n_blocks = moe_layout(cfg)
            use_moe = cfg.moe.num_experts > 0
            self.lead_blocks = nn.ModuleList(
                [Block(cfg, device=device) for _ in range(lead)])
            self.blocks = nn.ModuleList(
                [Block(cfg, use_moe=use_moe, device=device)
                 for _ in range(n_blocks)])
        elif cfg.family == "hybrid":
            n_mamba = hybrid_layout(cfg)[0]
            self.mamba = nn.ModuleList(
                [Mamba2Block(cfg, device=device) for _ in range(n_mamba)])
            self.mamba_ln = self._norms(n_mamba, device)
            self.shared = Block(cfg, device=device)
        else:
            n_m, n_s, _ = xlstm_layout(cfg)
            self.mlstm = nn.ModuleList(
                [MLSTMBlock(cfg, device=device) for _ in range(n_m)])
            self.mlstm_ln = self._norms(n_m, device)
            self.slstm = nn.ModuleList(
                [SLSTMBlock(cfg, device=device) for _ in range(n_s)])
            self.slstm_ln = self._norms(n_s, device)
        self.ln_f = L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=dt,
                              device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.Linear(cfg.d_model, cfg.vocab_size, dtype=dt,
                                 device=device))

    def _norms(self, n: int, device) -> nn.ModuleList:
        cfg = self.cfg
        return nn.ModuleList(
            [L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=cfg.param_dtype,
                       device=device) for _ in range(n)])

    def decoder_blocks(self) -> list[Block]:
        """The dense / moe block stack in layer order (the leading dense
        blocks first), one KV layer each."""
        return [*self.lead_blocks, *self.blocks]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + output projection; fp32 logits."""
        x = self.ln_f(x)
        if self.lm_head is None:
            return L.unembed(self.embed, x)
        return self.lm_head(x).float()


def make_cache(cfg: ModelConfig, *, max_seqs: int, num_pages: int,
               device, tp: int = 1,
               num_pools: int = 1) -> dict[str, dict[str, torch.Tensor]]:
    """The empty serving cache: {"attn": {"k_pages", "v_pages"}} of
    [n_attn, Hkv / tp, num_pools, num_pages, page_size, head_dim] in the
    param dtype (`num_pages` a pool: the reference's `make_cache_specs`,
    one pool a data-parallel shard; at tp > 1 one rank's whole heads of
    every page, the rank's block of the head axis) when the model has
    attention layers (MLA:
    {"k_pages"} of [n_attn, 1, num_pools, num_pages, page_size, r + rope],
    `kv_cache_dims`); for
    the hybrid family {"mamba": {"conv": [n_mamba, max_seqs, K-1,
    conv_dim] param dtype, "ssm": [n_mamba, max_seqs, H, N, P] fp32}}; for
    the ssm family {"mlstm": {"conv", "c", "n", "m"}, "slstm": {"h", "c",
    "n", "m"}} (`mlstm_cache_specs` / `slstm_cache_specs` with a leading
    layer axis), zeros but for both stabilisers `m`, which start at
    -inf."""
    cache = {}
    if attn_layer_count(cfg):
        hkv, dk, dv = kv_cache_dims(cfg)
        cache["attn"] = make_kv_cache(
            attn_layer_count(cfg), hkv, num_pools, num_pages, cfg.page_size,
            dk, dv, cfg.param_dtype, device, num_devices=tp)
    if cfg.family == "hybrid":
        groups = {"mamba": (hybrid_layout(cfg)[0], mamba2_cache_specs)}
    elif cfg.family == "ssm":
        n_m, n_s, _ = xlstm_layout(cfg)
        groups = {"mlstm": (n_m, mlstm_cache_specs),
                  "slstm": (n_s, slstm_cache_specs)}
    else:
        groups = {}
    for group, (n, specs) in groups.items():
        cache[group] = {
            k: torch.zeros((n,) + shape, dtype=dtype, device=device)
            for k, (shape, dtype) in specs(cfg, max_seqs).items()}
        if "m" in cache[group]:  # the xLSTM stabilisers start at -inf
            cache[group]["m"].fill_(-torch.inf)
    return cache


@torch.no_grad()
def apply_unified(model: Model, cache: dict, batch: dict, *, kernel_cfg=None,
                  num_decode_seqs: int = 0, sample: bool = False,
                  return_logits: bool = False, max_draft: int = 0,
                  shard=None):
    """Token-packed unified step.

    `cache` is the attention pages {"k_pages", "v_pages"} (the "attn"
    entry of `make_cache`).  batch (tensors on the model's device): inputs
    [1, T] token ids, positions [1, T] absolute per-token positions
    ([3, 1, T] for "mrope"),
    page_table [S, Np], context_lens [S], query_lens [S], query_start_loc
    [S+1], slot_mapping [1, T] pool-local KV write slots (trash slot for
    padded tokens).
    Sequences [0, num_decode_seqs) are the static decode region.  When
    `prev_tokens` [S] and `token_source` [1, T] are present, rows with
    `token_source >= 0` take their id from `prev_tokens[source]`.

    With `sample=True` the batch also carries the per-sequence sampling
    parameters as device tensors [S] (temperature, top_p, top_k) and
    `noise` [S, V]: each sampling row's Gumbel draw, zero elsewhere (the
    host part, `sampling.gumbel_noise`, runs before the step); `noise`
    None is only valid when every row is greedy.

    Speculative verify (`max_draft = K > 0`, needs `sample`): the batch
    also carries `spec_lens` [S] i32; a row with spec_lens == s > 0 is a
    decode request packed as a resumed chunk of s + 1 tokens [last real
    token, draft_1..draft_s].  Verify position j (0 <= j <= s) samples
    from the logits at segment offset qlen - 1 - s + j; `noise` is then
    [S * (K + 1), V], row i * (K + 1) + j drawn at counter
    num_generated + j (`sampling.verify_rows`), the draw sequential
    decoding makes for that token: on the same logits, the same token.  The head runs
    on the gathered S * (K + 1) rows only.  A row emits 1 + (the longest
    prefix of drafts equal to the sampled targets) tokens; plain rows
    (s = 0) reduce to the fused sample in column 0.

    Every shape inside depends on the batch's shapes alone, and nothing
    reads device data back to the host, so the engine can capture the
    step into a CUDA graph.  The cache is written IN PLACE (and returned,
    as the reference returns its new cache).  Returns (last_logits [S, V]
    f32, cache) without sampling; (tokens [S] i32, cache) with it; with
    `max_draft = K`, (tokens [S, K+1] i32, num_emitted [S] i32, cache);
    `return_logits=True` inserts last_logits before the cache.

    `shard` (`distributed.sharding.ShardCtx`) marks one rank of a
    head-parallel step (`serving/executor.py`): `cache` holds the rank's
    Hkv / tp heads, each attention layer computes its head block and
    all-gathers the outputs, so everything after it (the MLP or MoE, the
    head, sampling and the verify epilogue) runs replicated and alike on
    every rank."""
    if max_draft and not sample:
        raise ValueError("speculative verify samples: it needs sample=True")
    cfg = model.cfg
    if cfg.family not in DECODER_FAMILIES or cfg.mla.kv_lora_rank:
        raise ValueError(f"the packed step needs page-addressable context: "
                         f"unsupported for family={cfg.family!r}/MLA")
    inputs = batch["inputs"]
    if "token_source" in batch:
        src = batch["token_source"]
        inputs = torch.where(
            src >= 0, batch["prev_tokens"][torch.clamp(src, min=0).long()],
            inputs)
    positions = batch["positions"]
    kp, vp = cache["k_pages"], cache["v_pages"]
    meta = {k: batch[k] for k in ("page_table", "context_lens", "query_lens",
                                  "query_start_loc")}
    meta.update(num_decode_seqs=num_decode_seqs, write_index=write_index(
        batch["slot_mapping"], kp.shape[3] * kp.shape[4]),
        rope=glue_ops.step_rope(cfg, positions))
    x = L.embed(model.embed, inputs)  # [1, T, d]
    # each residual add is one kernel with the norm after it; the last
    # layer's add stays a plain add before the head
    blocks = model.decoder_blocks()
    h, x = GL.add_rms_norm(x, None, spmd.full(blocks[0].ln1.scale),
                           blocks[0].ln1.eps)
    for i, blk in enumerate(blocks):
        a = blk.attn(h, positions, kp[i], vp[i], meta,
                     kernel_cfg=kernel_cfg, shard=shard)
        h, x = GL.add_rms_norm(x, a, spmd.full(blk.ln2.scale), blk.ln2.eps)
        f = blk.ffn(h, packed=True)
        if i + 1 == len(blocks):
            x = x + f
        else:
            nxt = blocks[i + 1].ln1
            h, x = GL.add_rms_norm(x, f, spmd.full(nxt.scale), nxt.eps)
    # per-sequence last-token rows of the packed stream; the head is
    # row-wise, so it runs on these [S] rows instead of all T
    qsl, qlens = batch["query_start_loc"], batch["query_lens"]
    last = qsl[:-1] + torch.clamp(qlens - 1, min=0)
    last = torch.clamp(last, max=x.shape[1] - 1).long()
    if max_draft:
        return _verify(model, x, inputs, batch, last, max_draft,
                       return_logits) + (cache,)
    last_logits = model.head(x[0, last])
    if not sample:
        return last_logits, cache
    toks = sampling.sample_tokens(
        last_logits, batch["temperature"], batch["top_p"], batch["top_k"],
        batch.get("noise"))
    if return_logits:
        return toks, last_logits, cache
    return toks, cache


def _verify(model: Model, x: torch.Tensor, inputs: torch.Tensor,
            batch: dict, last: torch.Tensor, k: int,
            return_logits: bool) -> tuple:
    """The speculative verify epilogue of `apply_unified`: (tokens
    [S, k+1] i32, num_emitted [S] i32[, last_logits [S, V]]).  Columns of
    a row with s < k clamp to its segment start; they are never consumed
    (num_emitted caps at s + 1)."""
    spec = batch["spec_lens"].long()  # [S]
    s = spec.shape[0]
    offs = torch.arange(k + 1, device=x.device)
    start = batch["query_start_loc"][:-1].long()
    pos = last[:, None] - spec[:, None] + offs[None, :]  # [S, k+1]
    pos = torch.clamp(torch.maximum(pos, start[:, None]), max=last[:, None])
    pos = torch.clamp(pos, 0, x.shape[1] - 1)
    logits = model.head(x[0, pos.reshape(-1)])  # [S * (k+1), V]
    rep = lambda a: a.repeat_interleave(k + 1)  # noqa: E731
    toks = sampling.sample_tokens(
        logits, rep(batch["temperature"]), rep(batch["top_p"]),
        rep(batch["top_k"]), batch.get("noise")).reshape(s, k + 1)
    # the drafts are the packed inputs one slot after each verify
    # position; accept the longest prefix where target == draft
    dpos = torch.clamp(pos[:, :-1] + 1, 0, inputs.shape[1] - 1)
    drafts = inputs[0, dpos].to(torch.int32)  # [S, k]
    match = (toks[:, :-1] == drafts) & (offs[None, :-1] < spec[:, None])
    run = torch.cumprod(match.to(torch.int32), dim=1, dtype=torch.int32)
    num_emitted = 1 + run.sum(1, dtype=torch.int32)
    if not return_logits:
        return toks, num_emitted
    last_logits = logits.reshape(s, k + 1, -1)[
        torch.arange(s, device=x.device), spec]
    return toks, num_emitted, last_logits


def _serve_masks(mode: str, meta: dict, s: int):
    """(valid [B, S] bool, seq_lens [B]) of the padded serving modes: a
    prefill (or resumed prefill) row is valid up to its query length, a
    decode row where its slot is live."""
    if mode in ("prefill", "prefill_cached"):
        qlens = meta["query_lens"]
        valid = torch.arange(s, device=qlens.device)[None, :] < qlens[:, None]
        return valid, qlens
    live = meta["context_lens"] > 0
    return live[:, None], live.to(torch.int32)


def _add_write_index(meta: dict, cache: dict, positions: torch.Tensor,
                     valid: torch.Tensor) -> None:
    """The step's KV write index (`write_index`, shared by every attention
    layer): slots from `physical_slots` at the positions' temporal row,
    invalid tokens aimed at the trash slot and dropped.  Nothing for a
    model without attention layers."""
    if "attn" not in cache:
        return
    kp = cache["attn"]["k_pages"]  # [n_attn, Hkv, 1, P, ps, D]
    num_pages, ps = kp.shape[3], kp.shape[4]
    slots = physical_slots(meta["page_table"], temporal(positions), valid,
                           ps, num_pages)
    meta["write_index"] = write_index(slots.reshape(1, -1), num_pages * ps)


def _serve_forward(model: Model, x: torch.Tensor, positions: torch.Tensor,
                   cache: dict, meta: dict, *, mode: str, kernel_cfg):
    """The block stack of a padded serving step, writing every cache leaf
    in place.  x [B, S, d] -> [B, S, d]."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return _xlstm_forward(model, x, cache, meta, mode=mode)
    kp, vp = cache["attn"]["k_pages"], cache["attn"].get("v_pages")
    if cfg.family in DECODER_FAMILIES:
        for i, blk in enumerate(model.decoder_blocks()):
            x = blk.forward_serve(x, positions, kp[i],
                                  None if vp is None else vp[i], meta,
                                  mode=mode, kernel_cfg=kernel_cfg)
        return x
    valid, seq_lens = _serve_masks(mode, meta, x.shape[1])
    conv, ssm = cache["mamba"]["conv"], cache["mamba"]["ssm"]
    for kind, i in stack_order(*hybrid_layout(cfg)):
        if kind == "mid":
            x = model.shared.forward_serve(x, positions, kp[i], vp[i], meta,
                                           mode=mode, kernel_cfg=kernel_cfg)
            continue
        h, new_conv, new_ssm = model.mamba[i](
            model.mamba_ln[i](x), mode=mode, conv_state=conv[i],
            ssm_state=ssm[i], valid=valid, seq_lens=seq_lens)
        conv[i].copy_(new_conv)
        ssm[i].copy_(new_ssm)
        x = x + h
    return x


def _xlstm_forward(model: Model, x: torch.Tensor, cache: dict, meta: dict,
                   *, mode: str) -> torch.Tensor:
    """The xlstm block stack (position-free: the recurrence carries the
    order), writing the mLSTM / sLSTM cache rows in place."""
    valid, seq_lens = _serve_masks(mode, meta, x.shape[1])
    mc, sc = cache["mlstm"], cache["slstm"]
    for kind, i in stack_order(*xlstm_layout(model.cfg)):
        if kind == "rec":
            blk, ln, leaves, kw = (model.mlstm[i], model.mlstm_ln[i], mc,
                                   {"seq_lens": seq_lens})
        else:
            blk, ln, leaves, kw = model.slstm[i], model.slstm_ln[i], sc, {}
        h, new = blk(ln(x), mode=mode, cache={k: t[i] for k, t in
                                               leaves.items()},
                     valid=valid, **kw)
        for k, t in new.items():
            leaves[k][i].copy_(t)
        x = x + h
    return x


@torch.no_grad()
def apply_prefill(model: Model, cache: dict, batch: dict, *,
                  kernel_cfg=None):
    """Fresh prompts at context 0, padded to [B, S].  batch (tensors on the
    model's device): inputs [B, S] ids or [B, S, d] embeddings (`input_kind`
    "embeds"), positions [B, S] ([3, B, S] for "mrope"), page_table
    [B, Np], context_lens [B] and query_lens [B] (equal).  `cache` holds
    B slot rows of any state cache (the engine passes zeroed rows and
    merges them back).  Returns (last_token_logits [B, V] f32, cache)."""
    return _prefill(model, cache, batch, "prefill", kernel_cfg)


@torch.no_grad()
def apply_prefill_cached(model: Model, cache: dict, batch: dict, *,
                         kernel_cfg=None):
    """Resumed prefill at context > 0: only this step's chunk of each
    prompt is embedded and computed (inputs [B, S] the chunk's ids or
    [B, S, d] embeddings,
    positions absolute, context_lens = prior context + chunk, query_lens
    = chunk; page_table [B, np_b] may be narrowed to the context's
    pages).  The prior context (earlier chunks, a prefix-cache hit, or
    both) is read back from the pages: the chunk's KV is written at its
    absolute slots, then attention covers the whole paged context.
    Dense and moe families without MLA only (hybrid / ssm state is not
    page-addressable; MLA's latent rows serve fresh prompts only, as in
    the reference).  Returns (last_token_logits [B, V] f32, cache)."""
    cfg = model.cfg
    if cfg.family not in DECODER_FAMILIES or cfg.mla.kv_lora_rank:
        raise ValueError(f"resumed prefill needs page-addressable context: "
                         f"unsupported for family={cfg.family!r}/MLA")
    return _prefill(model, cache, batch, "prefill_cached", kernel_cfg)


def _prefill(model: Model, cache: dict, batch: dict, mode: str,
             kernel_cfg):
    meta = {k: batch[k] for k in ("page_table", "context_lens", "query_lens")}
    inputs, positions = batch["inputs"], batch["positions"]
    b, s = inputs.shape[:2]
    valid, _ = _serve_masks(mode, meta, s)
    _add_write_index(meta, cache, positions, valid)
    x = _serve_forward(model, _embed(model, inputs), positions, cache,
                       meta, mode=mode, kernel_cfg=kernel_cfg)
    # the head is row-wise: it runs on each row's last valid token only
    last = torch.clamp(meta["query_lens"].long() - 1, min=0)
    x = x[torch.arange(b, device=x.device), last]
    return _logits_block(model, model.ln_f(x)), cache


def _logits_block(model: Model, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the normed x [..., d] over this rank's block of the
    vocabulary where the rules split it (all of it without a mesh)."""
    cfg = model.cfg
    lo, hi = spmd.rank_range(cfg.vocab_size,
                             resolve((cfg.vocab_size,), "vocab")[0])
    if model.lm_head is None:
        return L.unembed(spmd.local_block(model.embed, 0, lo, hi), x)
    return model.lm_head.block(x, lo, hi).float()


@torch.no_grad()
def apply_decode(model: Model, cache: dict, batch: dict, *, kernel_cfg=None):
    """One token for each of B slots.  batch: inputs [B, 1] ids (also for
    an embeddings model: it decodes token ids, as the reference's engine
    gives them), positions [B, 1] (-1 on dead slots; [3, B, 1] for
    "mrope"), page_table [B, Np], context_lens [B] (0 on
    dead slots).  No host read of device data: the engine captures it
    into a CUDA graph.  Returns (logits [B, V] f32, cache)."""
    meta = {k: batch[k] for k in ("page_table", "context_lens")}
    positions = batch["positions"]
    valid = (temporal(positions) >= 0) & (meta["context_lens"][:, None] > 0)
    _add_write_index(meta, cache, positions, valid)
    x = _serve_forward(model, _embed(model, batch["inputs"]), positions,
                       cache, meta, mode="decode", kernel_cfg=kernel_cfg)
    return _logits_block(model, model.ln_f(x[:, 0])), cache


def default_positions(cfg: ModelConfig, b: int, s: int,
                      device=None) -> torch.Tensor:
    """[B, S] int32 positions 0..S-1 of every row; for "mrope" the same
    in each of the three rows, [3, B, S]."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    if cfg.rope_style == "mrope":
        pos = pos[None].expand(3, b, s)
    return pos


def _residual_train(blk, ln, x: torch.Tensor, s: int) -> torch.Tensor:
    """One pre-normed residual recurrent layer of training: x +
    blk.forward_train(ln(x)), the block reading the whole sequence of
    length s (on a mesh under sequence parallelism an all-gather of the
    normed rows) and returning the residual stream's layout."""
    return x + blk.forward_train(whole_seq(ln(x), s))


def _recurrent_train(model: Model, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """The hybrid and xlstm training stacks (`repro.models.model.
    _hybrid_forward` / `_xlstm_forward` in mode "train"): each Mamba2 /
    mLSTM layer body rematerialised, the shared block and the sLSTM
    blocks not; the shared block's weights collect one gradient summed
    over its uses."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        order = stack_order(*hybrid_layout(cfg))
        rec, rec_ln = model.mamba, model.mamba_ln
    else:
        order = stack_order(*xlstm_layout(cfg))
        rec, rec_ln = model.mlstm, model.mlstm_ln
    s = positions.shape[-1]
    for kind, i in order:
        if kind == "rec":
            x = checkpoint(_residual_train, rec[i], rec_ln[i], x, s,
                           use_reentrant=False,
                           context_fn=checkpoint_contexts)
        elif cfg.family == "hybrid":
            x = model.shared.forward_train(x, positions)[0]
        else:
            x = _residual_train(model.slstm[i], model.slstm_ln[i], x, s)
    return x


def _embed(model: Model, inputs: torch.Tensor) -> torch.Tensor:
    """The embedding of training and of the padded serving steps at the
    residual stream's layout (the reference's `constrain(x, "batch",
    "seq_sp", "embed")`): [B, S, d] embedding inputs (`input_kind`
    "embeds": the frontend's frame or patch embeddings) cast to the
    parameter dtype, or token ids [B, S] through the table (the
    reference's `_embed_inputs`).  On a mesh ids look up this rank's block of the
    vocabulary-split table, zero outside it, and the rows are a pending
    sum over 'model' (vocab parallelism); without one, the whole table."""
    cfg = model.cfg
    batch = spec("batch")[0]
    if cfg.input_kind == "embeds" and inputs.ndim == 3:
        x, split = inputs.to(cfg.param_dtype), False
    else:
        v_axes = resolve((cfg.vocab_size,), "vocab")[0]
        lo, hi = spmd.rank_range(cfg.vocab_size, v_axes)
        table = spmd.local_block(model.embed, 0, lo, hi)
        ids = inputs.long() - lo
        mine = (ids >= 0) & (ids < hi - lo)
        x = L.embed(table, torch.where(mine, ids, 0))
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        split = v_axes is not None
    return constrain(x, "batch", "seq_sp", "embed", held=(batch, None, None),
                     partial=("model",) if split else ())


def _loss(model: Model, x: torch.Tensor, labels: torch.Tensor):
    """(ce, token count) of the training logits: the head on this rank's
    block of the vocabulary ([b, S, V / M] fp32, the reference's
    `constrain(logits, "batch", "seq", "vocab")`; all of it without a
    mesh), the log-softmax over the whole vocabulary (by sums over
    'model' where it is split), and the reference's ce -sum(ll * mask) /
    max(sum(mask), 1) with both sums over the whole batch."""
    cfg = model.cfg
    batch = spec("batch")[0]
    v_axes = resolve((cfg.vocab_size,), "vocab")[0]
    lo, hi = spmd.rank_range(cfg.vocab_size, v_axes)
    x = whole_seq(model.ln_f(x), labels.shape[1])
    logits = constrain(_logits_block(model, x), "batch", "seq", "vocab",
                       held=(batch, None, v_axes))
    if v_axes is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, torch.clamp(labels, min=0).long()[
            ..., None])[..., 0]
    else:
        m = spmd.all_reduce_max(logits.max(-1).values, v_axes)
        lse = m + torch.log(spmd.all_reduce(
            torch.exp(logits - m[..., None]).sum(-1), v_axes))
        ids = torch.clamp(labels, min=0).long() - lo
        mine = (ids >= 0) & (ids < hi - lo)
        picked = torch.gather(logits, -1, torch.where(mine, ids, 0)[
            ..., None])[..., 0]
        ll = spmd.all_reduce(torch.where(mine, picked, 0.0), v_axes) - lse
    mask = (labels >= 0).float()
    tokens = spmd.all_reduce(mask.sum(), batch).detach()
    ce = -spmd.all_reduce(torch.sum(ll * mask), batch) \
        / torch.clamp(tokens, min=1.0)
    return ce, tokens


def apply_train(model: Model, batch: dict):
    """batch: {'inputs': [B, S] ids or [B, S, d] embeddings (`input_kind`
    "embeds"), 'labels': [B, S] (< 0: ignored), 'positions'?: [B, S], or
    [3, B, S] for "mrope"} as tensors on the model's device.  The blocks
    the reference runs under `jax.checkpoint` run under
    `torch.utils.checkpoint`, so the backward recomputes them: every
    dense / MoE block, and each Mamba2 and mLSTM layer body (norm, block,
    residual); the hybrid's shared attention block and the sLSTM blocks
    keep their activations, as in the reference.  Returns (loss, {"ce",
    "aux", "tokens"}): loss = ce + aux, aux the MoE blocks' load-balance
    losses summed in block order (0 for every other family).  Inside
    `sharding.use_rules` (a training mesh; every family) inputs, labels
    and positions are this rank's batch rows, and the loss, ce and aux are
    the whole batch's, equal on every rank."""
    inputs, labels = batch["inputs"], batch["labels"]
    b, s = labels.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(model.cfg, b, s, labels.device)
    x = _embed(model, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=labels.device)
    if model.cfg.family in ("hybrid", "ssm"):
        x = _recurrent_train(model, x, positions)
    else:
        for blk in model.decoder_blocks():
            x, a = checkpoint(blk.forward_train, x, positions,
                              use_reentrant=False,
                              context_fn=checkpoint_contexts)
            if a is not None:
                aux = aux + a
    ce, tokens = _loss(model, x, labels)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": tokens.to(torch.int32)}
