"""Train step: loss -> grads -> AdamW, with optional gradient accumulation
over microbatches.  The port of `repro.training.trainer`, on one device
or on a training mesh.

On a mesh (inside `sharding.use_rules`, the parameters placed by
`param_sharding.assign_param_shardings`) the step takes the *global*
batch, as the reference's jitted step does, and each rank keeps its block
of every microbatch (`assign_batch_shardings`: microbatch i is the
reference's i-th slice of the whole batch, then split over the batch
axes).  Every rank computes the whole batch's loss; each backpropagates
1 / N of it (N ranks), so a gradient it holds is its share of a sum
(`distributed/spmd.py`), completed over the axes a parameter is
replicated on (`spmd.reduce_grads`).  The clip's global norm is that of
the whole gradients (each block counted once: the blocks' sums of squares
from one `sum_squares` launch, summed over the ranks that split each
tensor), and AdamW updates each rank's blocks.

The parameters live in the `Model` and are updated in place by
`adamw_update` (no second parameter list is made); the train state holds
the rest (its moments updated in place too): {"opt": {"mu", "nu", "count"}, "step"}.  The
moments follow `list(model.parameters())` order.  The serving path keeps
its parameters frozen (`requires_grad=False`); `make_train_state` turns
gradients on.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import active_mesh, spec
from repro_torch.kernels.optimizer import kernel as OK
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


def make_train_state_abstract(cfg) -> tuple[Model, dict]:
    """(the model, its train state) on the meta device: shapes and dtypes,
    no storage (the reference's `jax.eval_shape` of `make_train_state`;
    the port's parameters live in the `Model`)."""
    model = Model(cfg, device="meta")
    return model, make_train_state(model)


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads); a parameter the loss does not reach (the
    embedding table of a model fed embeddings) gets a zero gradient, as
    `jax.grad` gives it.  On a mesh `batch` is the global (micro)batch:
    this rank takes its block, and its grads are its shares."""
    for p in params:
        p.grad = None
    mesh = active_mesh()
    if mesh is not None:
        batch_axes = spec("batch")[0]
        PS.require_batch_split(batch, mesh=mesh, batch_axes=batch_axes)
        batch = PS.assign_batch_shardings(batch, mesh=mesh,
                                          batch_axes=batch_axes)
    loss, metrics = apply_train(model, batch)
    (loss if mesh is None else loss / mesh.world).backward()
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
    gnorm = None
    mesh = active_mesh()
    if mesh is not None:
        specs = [spmd.placement(p) for p in params]
        spmd.reduce_grads(grads, specs, mesh)
        gnorm = spmd.global_norm(OK.sum_squares(grads), specs, mesh)
    lr = cosine_schedule(state["step"], base_lr=base_lr, warmup=warmup,
                         total=total_steps)
    _, new_opt, opt_metrics = adamw_update(
        grads, state["opt"], params, lr=lr, weight_decay=weight_decay,
        clip_norm=clip_norm, gnorm=gnorm)
    del grads
    for p in params:
        p.grad = None
    return ({"opt": new_opt, "step": state["step"] + 1},
            {"loss": loss, **opt_metrics, "ce": ce, "aux": aux})


def place_train_state(model: Model, state: dict, *, mesh, fsdp: bool,
                      batch_axes: tuple) -> dict:
    """Place a whole model and its train state on `mesh`
    (`assign_param_shardings`, the moments cut with their parameters);
    returns the state."""
    PS.assign_param_shardings(model, mesh=mesh, fsdp=fsdp,
                              batch_axes=batch_axes, opt_state=state["opt"])
    return state


@torch.no_grad()
def whole_state_tensors(model: Model, state: dict) -> dict[str, torch.Tensor]:
    """`state_tensors` with every placed block all-gathered whole (every
    rank of the mesh calls it, in the same order): what a checkpoint of a
    mesh run stores, so that it restores onto any mesh."""
    out = {}
    for name, t in state_tensors(model, state).items():
        out[name] = (spmd.full(t) if spmd.placement(t) is not None
                     else t).detach()
    return out


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
