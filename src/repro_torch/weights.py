"""Model weights: carried over from the JAX reference's parameter pytree,
drawn at random from a seed, or handed back in the reference's layout.

The JAX `M.init` pytree for a dense model is

    {"embed": {"table": [V, d]}, "ln_f": {"scale": [d]},
     "blocks": {"ln1": {"scale": [L, d]},
                "attn": {"wq": {"w": [L, d, Hq*Dh]}, "wk", "wv", "wo"},
                "ln2": {"scale": [L, d]},
                "mlp": {"gate": {"w": [L, d, F]}, "up", "down"}},
     ["lm_head": {"w": [d, V]}]}

with the blocks stacked on a leading [L] axis by `jax.vmap`.  The bridge
unstacks them into the port's `nn.ModuleList`; `to_numpy_params` stacks
them back.  Linear weights keep the [d_in, d_out] layout (`y = x @ w`),
so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model


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


def _linear_params(model: Model):
    """(block index, {"attn": {name: Linear}, "mlp": {name: Linear}})."""
    for i, blk in enumerate(model.blocks):
        yield i, {"attn": {"wq": blk.attn.wq, "wk": blk.attn.wk,
                           "wv": blk.attn.wv, "wo": blk.attn.wo},
                  "mlp": {"gate": blk.mlp.gate, "up": blk.mlp.up,
                          "down": blk.mlp.down}}


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: dict,
                    device="cuda") -> Model:
    """The port's `Model` holding exactly the values of the reference's
    parameter pytree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`)."""
    if cfg.fused_qkv or cfg.fused_mlp:
        raise NotImplementedError(
            "fused wqkv / gate_up layouts are not ported yet")
    model = Model(cfg, device="cpu")
    _copy(model.embed, params_np["embed"]["table"], "embed.table")
    _copy(model.ln_f.scale, params_np["ln_f"]["scale"], "ln_f.scale")
    if model.lm_head is not None:
        _copy(model.lm_head.w, params_np["lm_head"]["w"], "lm_head.w")
    blocks = params_np["blocks"]
    for i, lin in _linear_params(model):
        blk = model.blocks[i]
        _copy(blk.ln1.scale, blocks["ln1"]["scale"][i], f"blocks.ln1[{i}]")
        _copy(blk.ln2.scale, blocks["ln2"]["scale"][i], f"blocks.ln2[{i}]")
        for group, mods in lin.items():
            for name, mod in mods.items():
                p = blocks[group][name]
                _copy(mod.w, p["w"][i], f"blocks.{group}.{name}.w[{i}]")
                if mod.b is not None:
                    _copy(mod.b, p["b"][i], f"blocks.{group}.{name}.b[{i}]")
    return model.to(device)


@torch.no_grad()
def init_random(cfg: ModelConfig, seed: int, device="cuda") -> Model:
    """Random weights drawn like the reference's `M.init` (truncated normal
    at +-2 std, std = d_in ** -0.5; norm scales 1) from a seeded CPU
    `torch.Generator`, so every device gets the same values."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    model = Model(cfg, device="cpu")

    def draw(t: torch.Tensor, std: float) -> None:
        tmp = torch.empty(t.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        t.copy_(tmp.to(t.dtype))

    draw(model.embed, cfg.d_model ** -0.5)
    if model.lm_head is not None:
        draw(model.lm_head.w, cfg.d_model ** -0.5)
    for i, lin in _linear_params(model):
        blk = model.blocks[i]
        blk.ln1.scale.fill_(1.0)
        blk.ln2.scale.fill_(1.0)
        for mods in lin.values():
            for mod in mods.values():
                draw(mod.w, mod.w.shape[0] ** -0.5)
                if mod.b is not None:
                    mod.b.zero_()
    model.ln_f.scale.fill_(1.0)
    return model.to(device)


@torch.no_grad()
def to_numpy_params(model: Model, *, grads: bool = False) -> dict:
    """The inverse of `from_jax_params`: the model's parameters (or, with
    `grads=True`, their `.grad`) as the reference's pytree of numpy
    arrays, blocks stacked on a leading [L] axis, in fp32.  For tests
    that compare the port with the reference leaf by leaf."""
    def get(p: torch.Tensor) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.float().cpu().numpy()  # numpy has no bfloat16

    out = {"embed": {"table": get(model.embed)},
           "ln_f": {"scale": get(model.ln_f.scale)}}
    if model.lm_head is not None:
        out["lm_head"] = {"w": get(model.lm_head.w)}
    per_block = [lin for _, lin in _linear_params(model)]  # [L] dicts
    blocks = {
        "ln1": {"scale": np.stack([get(b.ln1.scale) for b in model.blocks])},
        "ln2": {"scale": np.stack([get(b.ln2.scale) for b in model.blocks])},
    }
    for group in ("attn", "mlp"):
        blocks[group] = {}
        for name, mod in per_block[0][group].items():
            leaf = {"w": np.stack([get(lin[group][name].w)
                                   for lin in per_block])}
            if mod.b is not None:
                leaf["b"] = np.stack([get(lin[group][name].b)
                                      for lin in per_block])
            blocks[group][name] = leaf
    out["blocks"] = blocks
    return out
