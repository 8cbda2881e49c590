"""The 10 assigned architectures (exact configs) + reduced smoke variants.

Sources as given in the assignment table; interpretation notes for hybrid
patterns are in DESIGN.md §5.
"""
from __future__ import annotations

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- hybrid: Mamba2 + shared attention blocks [arXiv:2411.15242] -----------
ZAMBA2_1P2B = register(ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_q_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, rope_theta=10000.0,
    ssm=SSMConfig(
        state_dim=64, num_heads=32, head_dim=128,  # d_inner=4096, P=128
        num_groups=1, conv_kernel=4, expand=2, chunk=128,
        shared_attn_period=6,  # blocks 5,11,17,23,29,35 are the shared block
    ),
    supports_long_context=True,
    source="arXiv:2411.15242; hf",
))

# --- dense [arXiv:2407.21783] ----------------------------------------------
LLAMA3_405B = register(ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_q_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, rope_theta=500000.0,
    source="arXiv:2407.21783; unverified",
))

SMOLLM_135M = register(ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_q_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, rope_theta=10000.0, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))

GLM4_9B = register(ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_q_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552, rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b; hf",
))

QWEN25_3B = register(ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_q_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, qkv_bias=True, rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
))

# --- MoE [hf:meta-llama/Llama-4-Scout-17B-16E] ------------------------------
LLAMA4_MAVERICK = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_q_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, rope_theta=500000.0,
    moe=MoEConfig(
        num_experts=128, top_k=1, num_shared_experts=1,
        d_ff_expert=8192, capacity_factor=1.25, moe_layer_period=1,
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))

# --- MoE + MLA [arXiv:2405.04434] -------------------------------------------
DEEPSEEK_V2 = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_q_heads=128, num_kv_heads=128,
    d_ff=12288,  # dense-layer FFN (first layer is dense in DSv2)
    vocab_size=102400, rope_theta=10000.0,
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160, top_k=6, num_shared_experts=2,
        d_ff_expert=1536, capacity_factor=1.25, moe_layer_period=1,
        first_k_dense=1,
    ),
    source="arXiv:2405.04434; hf",
))

# --- audio: decoder-only over EnCodec tokens [arXiv:2306.05284] -------------
MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_q_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, rope_style="none",
    input_kind="embeds",  # EnCodec frame embeddings from the stub frontend
    source="arXiv:2306.05284; hf",
))

# --- vlm: M-RoPE backbone [arXiv:2409.12191] --------------------------------
QWEN2_VL_2B = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_q_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, qkv_bias=True,
    rope_style="mrope", rope_theta=1000000.0, mrope_sections=(16, 24, 24),
    input_kind="embeds",  # patch+text embeddings from the stub frontend
    source="arXiv:2409.12191; hf",
))

# --- ssm: xLSTM (sLSTM + mLSTM) [arXiv:2405.04517] ---------------------------
XLSTM_350M = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_q_heads=4, num_kv_heads=4,
    d_ff=0,  # no separate FFN: blocks carry pf=2 up-projections internally
    vocab_size=50304, rope_style="none",
    ssm=SSMConfig(
        state_dim=0, num_heads=4, head_dim=512,  # d_inner=2048, 4 heads
        conv_kernel=4, expand=2, chunk=64,
        slstm_period=8,  # xLSTM[7:1]: one sLSTM per 8 blocks
    ),
    supports_long_context=True,
    source="arXiv:2405.04517; unverified",
))


ARCHS: dict[str, ModelConfig] = dict(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving smoke-test variant: small depth/width/experts/vocab,
    same block structure (hybrid/moe/mla/xlstm paths all exercised)."""
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=256,
        num_q_heads=max(cfg.num_q_heads // 4, 2),
        num_kv_heads=max(cfg.num_kv_heads // 4, 1),
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=64,
        dtype="float32",
        page_size=16,
    )
    if cfg.family == "hybrid":
        kw.update(
            num_layers=4, num_q_heads=4, num_kv_heads=4,
            ssm=cfg.ssm.__class__(
                state_dim=16, num_heads=4, head_dim=128,  # d_inner=2*256=512
                num_groups=1, conv_kernel=4, expand=2, chunk=32,
                shared_attn_period=2,
            ),
        )
    if cfg.family == "ssm":
        kw.update(
            num_layers=4, num_q_heads=2, num_kv_heads=2, d_ff=0,
            ssm=cfg.ssm.__class__(
                state_dim=0, num_heads=2, head_dim=256,  # d_inner=512
                conv_kernel=4, expand=2, chunk=32, slstm_period=2,
            ),
        )
    if cfg.moe.num_experts:
        kw["moe"] = cfg.moe.__class__(
            num_experts=4, top_k=min(cfg.moe.top_k, 2),
            num_shared_experts=cfg.moe.num_shared_experts,
            d_ff_expert=128, capacity_factor=2.0,
            moe_layer_period=cfg.moe.moe_layer_period,
        )
    if cfg.mla.kv_lora_rank:
        kw["mla"] = cfg.mla.__class__(
            q_lora_rank=64, kv_lora_rank=64, qk_nope_dim=32,
            qk_rope_dim=32, v_head_dim=64,
        )
        kw["head_dim"] = 0
    if cfg.rope_style == "mrope":
        kw["mrope_sections"] = (8, 12, 12)  # sums to reduced head_dim/2
    return cfg.replace(name=cfg.name + "-reduced", **kw)
