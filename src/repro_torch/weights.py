"""Model weights: carried over from the JAX reference's parameter pytree,
drawn at random from a seed, or handed back in the reference's layout.

The JAX `M.init` pytree of a dense model is

    {"embed": {"table": [V, d]}, "ln_f": {"scale": [d]},
     "blocks": {"ln1": {"scale": [L, d]},
                "attn": {"wq": {"w": [L, d, Hq*Dh]}, "wk", "wv", "wo"},
                "ln2": {"scale": [L, d]},
                "mlp": {"gate": {"w": [L, d, F]}, "up", "down"}},
     ["lm_head": {"w": [d, V]}]}

with the blocks stacked on a leading [L] axis by `jax.vmap`.  A hybrid
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
from repro_torch.models.model import Block, Model
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


def _block_leaves(blk: Block):
    """(path, tensor) of a decoder block, in the reference's tree order."""
    yield ("ln1", "scale"), blk.ln1.scale
    for name in ("wq", "wk", "wv", "wo"):
        lin = getattr(blk.attn, name)
        yield ("attn", name, "w"), lin.w
        if lin.b is not None:
            yield ("attn", name, "b"), lin.b
    yield ("ln2", "scale"), blk.ln2.scale
    for name in ("gate", "up", "down"):
        yield ("mlp", name, "w"), getattr(blk.mlp, name).w


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
    if model.cfg.family == "dense":
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


def _check_layouts(cfg: ModelConfig) -> None:
    if cfg.fused_qkv or cfg.fused_mlp:
        raise NotImplementedError(
            "fused wqkv / gate_up layouts are not ported yet")


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: dict,
                    device="cuda") -> Model:
    """The port's `Model` holding exactly the values of the reference's
    parameter pytree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`)."""
    _check_layouts(cfg)
    model = Model(cfg, device="cpu")
    for path, i, t in _leaves(model):
        src = params_np
        for key in path:
            src = src[key]
        what = ".".join(path) + ("" if i is None else f"[{i}]")
        _copy(t, src if i is None else src[i], what)
    return model.to(device)


@torch.no_grad()
def init_random(cfg: ModelConfig, seed: int, device="cuda") -> Model:
    """Random weights drawn like the reference's `M.init` from a seeded CPU
    `torch.Generator`, so every device gets the same values: matrices (and
    the conv kernel) truncated normal at +-2 std with std = d_in ** -0.5
    (the embedding: d_model ** -0.5; the sLSTM's recurrent blocks `r`:
    (d / H) ** -0.5); norm scales and `d_skip` 1; biases, `a_log` and
    `dt_bias` 0."""
    _check_layouts(cfg)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    model = Model(cfg, device="cpu")
    for path, _, t in _leaves(model):
        name = path[-1]
        if name in ("scale", "d_skip"):
            t.fill_(1.0)
        elif name in ("b", "a_log", "dt_bias"):
            t.zero_()
        else:
            fan_in = {"table": cfg.d_model, "r": t.shape[-1]}.get(
                name, t.shape[0])
            std = fan_in ** -0.5
            tmp = torch.empty(t.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
            t.copy_(tmp.to(t.dtype))
    return model.to(device)


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
    return out
