"""Model weights: carried over from the JAX reference's parameter pytree,
drawn at random from a seed, or handed back in the reference's layout.

The JAX `M.init` pytree of a dense model (families "dense", "audio" and
"vlm") is

    {"embed": {"table": [V, d]}, "ln_f": {"scale": [d]},
     "blocks": {"ln1": {"scale": [L, d]},
                "attn": {"wq": {"w": [L, d, Hq*Dh], ["b": [L, Hq*Dh]]},
                         "wk", "wv", "wo"},
                "ln2": {"scale": [L, d]},
                "mlp": {"gate": {"w": [L, d, F]}, "up", "down"}},
     ["lm_head": {"w": [d, V]}]}

with the blocks stacked on a leading [L] axis by `jax.vmap`.  With
`fused_qkv` "attn" holds {"wqkv": {"w": [L, d, (Hq + 2 Hkv) Dh], ["b"]},
"wo"}, and with `fused_mlp` "mlp" holds {"gate_up": {"w": [L, d, 2 F]},
"down"}, in every decoder block (a MoE model's lead blocks and zamba2's
shared block too; MLA and the MoE's shared expert keep their leaves).  A MoE
model's blocks hold, in place of "mlp",

    "moe": {"router": {"w": [L, d, E]} (fp32), "w_gate": [L, E, d, ff],
            "w_up": [L, E, d, ff], "w_down": [L, E, ff, d],
            ["shared": {"gate": {"w": [L, d, ff s]}, "up", "down"}]}

after `first_k_dense` unstacked dense blocks in the list "lead_blocks"
(`[{"ln1", "attn", "ln2", "mlp"}, ...]`).  An MLA model's (deepseek-v2)
"attn" holds

    {"wkv_a": {"w"}, "kv_norm": {"scale"}, "wk_b": {"w"}, "wv_b": {"w"},
     "wo": {"w"}, "wq_a": {"w"}, "q_norm": {"scale"}, "wq_b": {"w"}}

with "wq" in place of the three q leaves where `q_lora_rank` is 0.  A hybrid
(zamba2) model has, besides embed / ln_f / lm_head,

    {"mamba": {"in_proj": {"w": [n, d, in_dim]}, "conv_w": [n, K, conv],
               "a_log": [n, H], "d_skip": [n, H], "dt_bias": [n, H],
               "norm": {"scale": [n, d_inner]},
               "out_proj": {"w": [n, d_inner, d]}},
     "mamba_ln": {"scale": [n, d]},
     "shared": one decoder block, unstacked}

and an xlstm (family "ssm") model, with m mLSTM and s sLSTM blocks and
d_inner = H * P,

    {"mlstm": {"in_proj": {"w": [m, d, 2 d_inner]}, "conv_w": [m, K, d_inner],
               "wq": {"w": [m, d_inner, d_inner]}, "wk", "wv",
               "w_gates": {"w": [m, d_inner, 2H], "b": [m, 2H]},
               "norm": {"scale": [m, d_inner]},
               "out_proj": {"w": [m, d_inner, d]}},
     "mlstm_ln": {"scale": [m, d]},
     "slstm": {"w_in": {"w": [s, d, 4d], "b": [s, 4d]},
               "r": [s, 4, H, d/H, d/H], "norm": {"scale": [s, d]},
               "up": {"w": [s, d, 2d]}, "down": {"w": [s, d, d]}},
     "slstm_ln": {"scale": [s, d]}}

The bridge unstacks them into the port's `nn.ModuleList`s;
`to_numpy_params` stacks them back.  Linear weights keep the [d_in, d_out]
layout (`y = x @ w`), so nothing is transposed.  `a_log`, `d_skip`,
`dt_bias` and the mLSTM's `w_gates` stay fp32 in a bf16 model, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import MLAAttention
from repro_torch.models.layers import RMSNorm
from repro_torch.models.model import DECODER_FAMILIES, Block, Model
from repro_torch.models.moe import MoE
from repro_torch.models.ssm_blocks import Mamba2Block, MLSTMBlock, SLSTMBlock


def _tensor(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16, which torch cannot read directly)
    -> CPU tensor with the same values and dtype."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _copy(dst: torch.Tensor, src, what: str) -> None:
    src = _tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)} does not match "
                         f"the port's {tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))


def _attn_leaves(attn):
    """(path under "attn", tensor) of a GQA or an MLA attention module."""
    if isinstance(attn, MLAAttention):
        names = ("wq_a", "q_norm", "wq_b") if attn.q_lora else ("wq",)
        for name in names + ("wkv_a", "kv_norm", "wk_b", "wv_b", "wo"):
            mod = getattr(attn, name)
            if isinstance(mod, RMSNorm):
                yield (name, "scale"), mod.scale
            else:
                yield (name, "w"), mod.w
        return
    yield from _linear_leaves(
        attn, ("wqkv", "wo") if hasattr(attn, "wqkv")
        else ("wq", "wk", "wv", "wo"))


def _block_leaves(blk: Block):
    """(path, tensor) of a decoder block, in the reference's tree order."""
    yield ("ln1", "scale"), blk.ln1.scale
    for path, t in _attn_leaves(blk.attn):
        yield ("attn",) + path, t
    yield ("ln2", "scale"), blk.ln2.scale
    if hasattr(blk, "moe"):
        for path, t in _moe_leaves(blk.moe):
            yield ("moe",) + path, t
        return
    names = (("gate_up", "down") if hasattr(blk.mlp, "gate_up")
             else ("gate", "up", "down"))
    for name in names:
        yield ("mlp", name, "w"), getattr(blk.mlp, name).w


# the [E, d_in, d_out] expert stacks of a MoE block
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _moe_leaves(moe: MoE):
    yield ("router", "w"), moe.router.w
    for name in _EXPERT_LEAVES:
        yield (name,), getattr(moe, name)
    if moe.shared is not None:
        for name in ("gate", "up", "down"):
            yield ("shared", name, "w"), getattr(moe.shared, name).w


def _mamba_leaves(blk: Mamba2Block):
    yield ("in_proj", "w"), blk.in_proj.w
    yield ("conv_w",), blk.conv_w
    yield ("a_log",), blk.a_log
    yield ("d_skip",), blk.d_skip
    yield ("dt_bias",), blk.dt_bias
    yield ("norm", "scale"), blk.norm.scale
    yield ("out_proj", "w"), blk.out_proj.w


def _linear_leaves(blk, names):
    for name in names:
        lin = getattr(blk, name)
        yield (name, "w"), lin.w
        if lin.b is not None:
            yield (name, "b"), lin.b


def _mlstm_leaves(blk: MLSTMBlock):
    yield from _linear_leaves(blk, ("in_proj",))
    yield ("conv_w",), blk.conv_w
    yield from _linear_leaves(blk, ("wq", "wk", "wv", "w_gates"))
    yield ("norm", "scale"), blk.norm.scale
    yield from _linear_leaves(blk, ("out_proj",))


def _slstm_leaves(blk: SLSTMBlock):
    yield from _linear_leaves(blk, ("w_in",))
    yield ("r",), blk.r
    yield ("norm", "scale"), blk.norm.scale
    yield from _linear_leaves(blk, ("up", "down"))


def _leaves(model: Model):
    """(path in the reference tree, index on its stacked [L] axis or None,
    tensor) for every parameter of the model."""
    yield ("embed", "table"), None, model.embed
    yield ("ln_f", "scale"), None, model.ln_f.scale
    if model.lm_head is not None:
        yield ("lm_head", "w"), None, model.lm_head.w
    if model.cfg.family in DECODER_FAMILIES:
        for j, blk in enumerate(model.lead_blocks):
            for path, t in _block_leaves(blk):
                yield ("lead_blocks", j) + path, None, t
        for i, blk in enumerate(model.blocks):
            for path, t in _block_leaves(blk):
                yield ("blocks",) + path, i, t
        return
    if model.cfg.family == "ssm":
        for group, per_block in (("mlstm", _mlstm_leaves),
                                 ("slstm", _slstm_leaves)):
            for i, blk in enumerate(getattr(model, group)):
                for path, t in per_block(blk):
                    yield (group,) + path, i, t
            for i, ln in enumerate(getattr(model, group + "_ln")):
                yield (group + "_ln", "scale"), i, ln.scale
        return
    for i, blk in enumerate(model.mamba):
        for path, t in _mamba_leaves(blk):
            yield ("mamba",) + path, i, t
    for i, ln in enumerate(model.mamba_ln):
        yield ("mamba_ln", "scale"), i, ln.scale
    for path, t in _block_leaves(model.shared):
        yield ("shared",) + path, None, t


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: dict,
                    device="cuda") -> Model:
    """The port's `Model` holding exactly the values of the reference's
    parameter pytree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`)."""
    model = Model(cfg, device="cpu")
    for path, i, t in _leaves(model):
        src = params_np
        for key in path:
            src = src[key]
        what = ".".join(map(str, path)) + ("" if i is None else f"[{i}]")
        _copy(t, src if i is None else src[i], what)
    return model.to(device)


# the most fp32 elements a device draw of a MoE model holds at once (an
# expert matrix above it is still drawn whole: 168 MB at maverick's width)
_PIECE = 1 << 25


@torch.no_grad()
def init_random(cfg: ModelConfig, seed: int, device="cuda", *,
                on_device: bool | None = None) -> Model:
    """Random weights drawn like the reference's `M.init`: matrices (and
    the conv kernel) truncated normal at +-2 std with std = d_in ** -0.5
    (the embedding: d_model ** -0.5; the sLSTM's recurrent blocks `r`:
    (d / H) ** -0.5; an expert matrix [d_in, d_out]: d_in ** -0.5); norm
    scales and `d_skip` 1; biases, `a_log` and `dt_bias` 0.

    The model is allocated on `device` and filled leaf by leaf, in the
    order of `_leaves`.  Where the draws are made:

      * dense, hybrid and ssm models: by one seeded CPU `torch.Generator`,
        each leaf whole in fp32, cast to its dtype and copied into place:
        the same values on every device (the card-versus-CPU checks build
        both models from one seed);
      * MoE models: by a generator on `device`, seeded with `seed`, each
        leaf in fp32 pieces along its first axis (one expert matrix of an
        expert stack at a time, at most 2^25 elements of any other leaf)
        cast into place, so a full-width model (34.6 G parameters at
        llama4-maverick's width, 2 layers) never holds its fp32 draws on
        the host.  The values differ between a CPU and a card build from
        one seed: a comparison across devices moves one model to the
        other device.

    `on_device` overrides that choice (True: a dense model drawn on the
    device too, as a MoE model is, so that ranks of one card build the
    same full-size model in seconds; the values then differ from a CPU
    draw of the same seed).
    """
    dev = torch.device(device)
    if on_device is None:
        on_device = cfg.family == "moe"
    gen = torch.Generator(device=dev if on_device else "cpu")
    gen.manual_seed(seed)
    model = Model(cfg, device=dev)
    for path, _, t in _leaves(model):
        name = path[-1]
        if name in ("scale", "d_skip"):
            t.fill_(1.0)
            continue
        if name in ("b", "a_log", "dt_bias"):
            t.zero_()
            continue
        fan_in = {"table": cfg.d_model, "r": t.shape[-1]}.get(
            name, t.shape[1] if name in _EXPERT_LEAVES else t.shape[0])
        std = fan_in ** -0.5
        if not on_device:
            tmp = torch.empty(t.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
            t.copy_(tmp.to(t.dtype))
            continue
        if name in _EXPERT_LEAVES:
            pieces = t.unbind(0)
        else:
            pieces = t.split(max(1, _PIECE // t[0].numel()) if t.ndim > 1
                             else _PIECE)
        for piece in pieces:
            tmp = torch.empty(piece.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
            piece.copy_(tmp)
    return model


@torch.no_grad()
def to_numpy_params(model: Model, *, grads: bool = False) -> dict:
    """The inverse of `from_jax_params`: the model's parameters (or, with
    `grads=True`, their `.grad`) as the reference's pytree of numpy
    arrays, stacked leaves on their leading [L] axis, in fp32.  For tests
    that compare the port with the reference leaf by leaf."""
    def get(p: torch.Tensor) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.float().cpu().numpy()  # numpy has no bfloat16

    out: dict = {}
    for path, i, t in _leaves(model):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if i is None:
            node[path[-1]] = get(t)
        else:
            node.setdefault(path[-1], []).append(get(t))

    def stack(node):
        for k, v in node.items():
            if isinstance(v, list):
                node[k] = np.stack(v)
            elif isinstance(v, dict):
                stack(v)
    stack(out)
    if "lead_blocks" in out:  # the reference's list of unstacked blocks
        lead = out["lead_blocks"]
        out["lead_blocks"] = [lead[j] for j in range(len(lead))]
    return out
