"""Dense decoder model: its unified (token-packed) serving step and its
training loss.

`Model` is embed -> L decoder blocks (RMSNorm, GQA attention, RMSNorm,
SwiGLU MLP, both residual) -> `ln_f` -> head (tied to the embedding for
smollm).  `apply_unified` is the port of `repro.models.model.apply_unified`:
one call covers decode rows, fresh prefill chunks and resumed chunks of a
packed [1, T] stream over the paged cache, plus the last-token gather and,
with `sample=True`, fused sampling.  `apply_train` is the port of
`repro.models.model.apply_train`: causal attention over the whole
sequence, every block rematerialised in the backward, then the masked
fp32 cross-entropy.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged.kv_cache import live_slots, make_kv_cache
from repro_torch.models import layers as L
from repro_torch.models import sampling
from repro_torch.models.attention import Attention


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=dt,
                             device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=dt,
                             device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype=dt, device=device,
                         fused=cfg.fused_mlp)

    def forward_train(self, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn.forward_train(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class Model(nn.Module):
    """Dense decoder (family "dense").  Parameters are allocated empty:
    fill them with `weights.from_jax_params` or `weights.init_random`."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family != "dense" or cfg.mla.kv_lora_rank:
            raise NotImplementedError(
                f"family={cfg.family!r} is not ported yet (dense only)")
        if cfg.input_kind != "tokens":
            raise NotImplementedError("embedding inputs are not ported yet")
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=dt, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(
            [Block(cfg, device=device) for _ in range(cfg.num_layers)])
        self.ln_f = L.RMSNorm(cfg.d_model, eps=cfg.norm_eps, dtype=dt,
                              device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.Linear(cfg.d_model, cfg.vocab_size, dtype=dt,
                                 device=device))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + output projection; fp32 logits."""
        x = self.ln_f(x)
        if self.lm_head is None:
            return L.unembed(self.embed, x)
        return self.lm_head(x).float()


def make_cache(cfg: ModelConfig, *, num_pages: int,
               device) -> dict[str, torch.Tensor]:
    """The serving KV cache {'k_pages', 'v_pages'}:
    [L, Hkv, 1, num_pages, page_size, head_dim] in the param dtype (one
    pool: a single device)."""
    return make_kv_cache(cfg.num_layers, cfg.num_kv_heads, 1,
                         num_pages, cfg.page_size, cfg.resolved_head_dim,
                         cfg.param_dtype, device)


@torch.no_grad()
def apply_unified(model: Model, cache: dict, batch: dict, *, kernel_cfg=None,
                  num_decode_seqs: int = 0, sample: bool = False,
                  seed: int = 0, return_logits: bool = False,
                  max_draft: int = 0):
    """Token-packed unified step.

    batch (tensors on the model's device): inputs [1, T] token ids,
    positions [1, T] absolute per-token positions, page_table [S, Np],
    context_lens [S], query_lens [S], query_start_loc [S+1], slot_mapping
    [1, T] pool-local KV write slots (trash slot for padded tokens).
    Sequences [0, num_decode_seqs) are the static decode region.  When
    `prev_tokens` [S] and `token_source` [1, T] are present, rows with
    `token_source >= 0` take their id from `prev_tokens[source]`.

    With `sample=True` the batch also carries the per-sequence sampling
    parameters as HOST arrays [S]: temperature, top_p, top_k, stream_ids
    and num_generated.  The host decides which rows draw noise (temperature
    > 0) and seeds each from (seed, stream id, num_generated), see
    `sampling.gumbel_noise`; greedy rows need no noise at all.

    The cache is written IN PLACE (and returned, as the reference returns
    its new cache).  Returns (last_logits [S, V] f32, cache) without
    sampling; (tokens [S] i32, cache) with it; `return_logits=True`
    inserts last_logits before the cache."""
    if max_draft:
        raise NotImplementedError("speculative verify is not ported yet")
    inputs = batch["inputs"]
    if "token_source" in batch:
        src = batch["token_source"]
        inputs = torch.where(
            src >= 0, batch["prev_tokens"][torch.clamp(src, min=0).long()],
            inputs)
    positions = batch["positions"]
    kp, vp = cache["k_pages"], cache["v_pages"]
    rows, dest = live_slots(batch["slot_mapping"], kp.shape[3] * kp.shape[4])
    meta = {k: batch[k] for k in ("page_table", "context_lens", "query_lens",
                                  "query_start_loc")}
    meta.update(num_decode_seqs=num_decode_seqs, write_rows=rows,
                write_dest=dest)
    x = L.embed(model.embed, inputs)  # [1, T, d]
    for i, blk in enumerate(model.blocks):
        x = x + blk.attn(blk.ln1(x), positions, kp[i], vp[i], meta,
                         kernel_cfg=kernel_cfg)
        x = x + blk.mlp(blk.ln2(x))
    # per-sequence last-token rows of the packed stream; the head is
    # row-wise, so it runs on these [S] rows instead of all T
    qsl, qlens = batch["query_start_loc"], batch["query_lens"]
    last = qsl[:-1] + torch.clamp(qlens - 1, min=0)
    last = torch.clamp(last, max=x.shape[1] - 1).long()
    last_logits = model.head(x[0, last])
    if not sample:
        return last_logits, cache
    dev = last_logits.device
    temps = torch.as_tensor(batch["temperature"], dtype=torch.float32,
                            device=dev)
    hot = [i for i, t in enumerate(batch["temperature"]) if t > 0]
    noise = sampling.gumbel_noise(
        seed, batch["stream_ids"], batch["num_generated"],
        last_logits.shape[-1], dev, rows=hot) if hot else None
    toks = sampling.sample_tokens(
        last_logits, temps,
        torch.as_tensor(batch["top_p"], dtype=torch.float32, device=dev),
        torch.as_tensor(batch["top_k"], dtype=torch.int32, device=dev),
        noise)
    if return_logits:
        return toks, last_logits, cache
    return toks, cache


def default_positions(b: int, s: int, device=None) -> torch.Tensor:
    """[B, S] int32 positions 0..S-1 of every row."""
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def apply_train(model: Model, batch: dict):
    """batch: {'inputs': [B, S] ids, 'labels': [B, S] (< 0: ignored),
    'positions'?: [B, S]} as tensors on the model's device.  Each block
    runs under `torch.utils.checkpoint`, so the backward recomputes it,
    as the reference's `jax.checkpoint` over the layer scan does.
    Returns (loss, {"ce", "aux", "tokens"}); aux is 0 for a dense
    model."""
    inputs, labels = batch["inputs"], batch["labels"]
    b, s = labels.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(b, s, labels.device)
    x = L.embed(model.embed, inputs)
    for blk in model.blocks:
        x = checkpoint(blk.forward_train, x, positions, use_reentrant=False)
    logp = torch.log_softmax(model.head(x), dim=-1)
    mask = (labels >= 0).float()
    ll = torch.gather(logp, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -torch.sum(ll * mask) / denom
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux,
                  "tokens": mask.sum().to(torch.int32)}
