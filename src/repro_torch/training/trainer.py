"""Train step: loss -> grads -> AdamW, with optional gradient accumulation
over microbatches.  The port of `repro.training.trainer` on one device.

The parameters live in the `Model` and are updated in place by
`adamw_update` (no second parameter list is made); the train state holds
the rest (its moments updated in place too): {"opt": {"mu", "nu", "count"}, "step"}.  The
moments follow `list(model.parameters())` order.  The serving path keeps
its parameters frozen (`requires_grad=False`); `make_train_state` turns
gradients on.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model, apply_train
from repro_torch.training.optimizer import (
    adamw_init, adamw_update, cosine_schedule,
)


def make_train_state(model: Model) -> dict:
    model.requires_grad_(True)
    params = list(model.parameters())
    return {"opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params[0].device)}


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads); a parameter the loss does not reach (the
    embedding table of a model fed embeddings) gets a zero gradient, as
    `jax.grad` gives it."""
    for p in params:
        p.grad = None
    loss, metrics = apply_train(model, batch)
    loss.backward()
    return loss.detach(), metrics, [
        torch.zeros_like(p) if p.grad is None else p.grad for p in params]


def _micro(name: str, v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """The i-th of n sequential slices of a batch entry along its batch
    axis: axis 1 of M-RoPE's [3, B, S] positions, else axis 0."""
    axis = 1 if name == "positions" and v.ndim == 3 else 0
    return v.unflatten(axis, (n, v.shape[axis] // n)).select(axis, i)


def train_step(model: Model, state: dict, batch: dict, *,
               base_lr: float = 3e-4, warmup: int = 100,
               total_steps: int = 10_000, weight_decay: float = 0.1,
               clip_norm: float = 1.0, microbatches: int = 1):
    """One optimizer step on `batch` ({'inputs' [B, S] ids or [B, S, d]
    embeddings, 'labels' [B, S], 'positions'? [B, S] or [3, B, S]}
    tensors on the model's device).  With microbatches > 1 the gradients of
    sequential slices of the batch are summed in fp32 and averaged, as the
    reference's scan does.  Returns (new_state, {"loss", "grad_norm",
    "lr", "ce", "aux"}), each a 0-d tensor; ce and aux are averaged over
    the microbatches."""
    params = list(model.parameters())
    if microbatches == 1:
        loss, metrics, grads = _value_and_grad(model, params, batch)
        ce, aux = metrics["ce"].detach(), metrics["aux"].detach()
    else:
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]
        loss = ce = aux = 0.0
        for i in range(microbatches):
            micro = {k: _micro(k, v, i, microbatches)
                     for k, v in batch.items()}
            l_, m, g = _value_and_grad(model, params, micro)
            for acc, gi in zip(gsum, g):
                acc.add_(gi)
            loss = loss + l_
            ce = ce + m["ce"].detach()
            aux = aux + m["aux"].detach()
        grads = [g / microbatches for g in gsum]
        loss, ce, aux = (x / microbatches for x in (loss, ce, aux))
    lr = cosine_schedule(state["step"], base_lr=base_lr, warmup=warmup,
                         total=total_steps)
    _, new_opt, opt_metrics = adamw_update(
        grads, state["opt"], params, lr=lr, weight_decay=weight_decay,
        clip_norm=clip_norm)
    del grads
    for p in params:
        p.grad = None
    return ({"opt": new_opt, "step": state["step"] + 1},
            {"loss": loss, **opt_metrics, "ce": ce, "aux": aux})


def state_tensors(model: Model, state: dict) -> dict[str, torch.Tensor]:
    """The train state and the parameters as one flat {name: tensor}
    dict, for `checkpoint.save`."""
    out = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        out[f"params/{name}"] = p
        out[f"opt/mu/{name}"] = state["opt"]["mu"][i]
        out[f"opt/nu/{name}"] = state["opt"]["nu"][i]
    out["opt/count"] = state["opt"]["count"]
    out["step"] = state["step"]
    return out


@torch.no_grad()
def load_state_tensors(model: Model, tensors: dict[str, torch.Tensor]) -> dict:
    """The inverse of `state_tensors`: copies the parameters into `model`
    and returns the train state on the model's device."""
    state = make_train_state(model)
    want = state_tensors(model, state)
    if set(want) != set(tensors):
        raise ValueError(f"checkpoint keys differ from the model's: missing "
                         f"{sorted(set(want) - set(tensors))[:4]}, extra "
                         f"{sorted(set(tensors) - set(want))[:4]}")
    for key, dst in want.items():
        src = tensors[key]
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{key}: checkpoint has {tuple(src.shape)} "
                             f"{src.dtype}, the model {tuple(dst.shape)} "
                             f"{dst.dtype}")
        dst.copy_(src)
    return state
