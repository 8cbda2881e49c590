"""Architecture config schema (PyTorch port).

Every supported architecture is a `ModelConfig`; `registry.reduced()`
produces the family-preserving smoke-test variant.  The dataclasses match
the JAX reference field for field, so a config built on one side can be
rebuilt on the other from the same keyword arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_layer_period: int = 1  # every Nth layer is MoE (llama4 uses 1 here)
    first_k_dense: int = 0  # leading dense-FFN layers (DeepSeek-V2 uses 1)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (hybrid) / xLSTM block parameters."""
    state_dim: int = 0  # N
    num_heads: int = 0
    head_dim: int = 0  # P
    num_groups: int = 1  # B/C groups
    conv_kernel: int = 4
    expand: int = 2  # d_inner = expand * d_model
    chunk: int = 128
    # hybrid (zamba2): every `shared_attn_period`-th block is the shared
    # global attention block
    shared_attn_period: int = 0
    # xlstm: one sLSTM per `slstm_period` blocks (rest mLSTM)
    slstm_period: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_q_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_q_heads
    qkv_bias: bool = False
    rope_style: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    input_kind: Literal["tokens", "embeds"] = "tokens"
    dtype: str = "bfloat16"
    page_size: int = 16
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    mla: MLAConfig = dataclasses.field(default_factory=MLAConfig)
    ssm: SSMConfig = dataclasses.field(default_factory=SSMConfig)
    supports_long_context: bool = False
    source: str = ""
    fused_qkv: bool = False
    fused_mlp: bool = False
    mla_fused_prefill: bool = False
    decode_blockscan: bool = False
    moe_ep_serve: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_q_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applies(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(applies?, reason-if-not).  long_500k only for sub-quadratic
    architectures."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "SKIP(long_500k: pure full-attention arch)"
    return True, ""


def _abstract(shape, dtype) -> torch.Tensor:
    """The port's abstract value: a meta tensor (shape and dtype, no
    storage)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def positions_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    """[B, S] int32 positions; [3, B, S] for M-RoPE."""
    if cfg.rope_style == "mrope":
        return _abstract((3, b, s), torch.int32)
    return _abstract((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                pages_per_seq: int | None = None) -> dict:
    """Meta-tensor stand-ins for every model input of a cell (the
    reference's ShapeDtypeStructs, key for key).

    train:   tokens / embeds + labels + positions
    prefill: tokens / embeds + positions + query_lens + paged metadata
    decode:  one new token a sequence (token ids also for an embeddings
             model) + positions + paged metadata; the KV cache is passed
             beside the batch (`models.model.make_cache`)
    """
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32

    def inputs():
        if cfg.input_kind == "embeds":
            return _abstract((b, s, cfg.d_model), cfg.param_dtype)
        return _abstract((b, s), tok)

    if shape.kind == "train":
        return {"inputs": inputs(), "labels": _abstract((b, s), tok),
                "positions": positions_spec(cfg, b, s)}
    np_ = pages_per_seq or -(-s // cfg.page_size)
    meta = {"page_table": _abstract((b, np_), tok),
            "context_lens": _abstract((b,), tok)}
    if shape.kind == "prefill":
        return {"inputs": inputs(), "positions": positions_spec(cfg, b, s),
                "query_lens": _abstract((b,), tok), **meta}
    return {"inputs": _abstract((b, 1), tok),
            "positions": positions_spec(cfg, b, 1), **meta}
