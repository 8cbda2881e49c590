"""AdamW and the cosine schedule as plain functions on lists of tensors.

The port of `repro.training.optimizer`.  The moments are fp32 whatever the
parameter dtype, and each update runs in fp32 and is cast back to the
parameter's dtype: no fp32 master copy, as in the reference.
`torch.optim.AdamW` keeps its moments in the parameter dtype, so for bf16
parameters it computes a different function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.misc import global_norm


def adamw_init(params: list[torch.Tensor]) -> dict:
    """{"mu": [...], "nu": [...]} fp32 zeros like `params`, "count" 0."""
    def zeros():
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]

    dev = params[0].device if params else "cpu"
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `base_lr`, then cosine decay to `min_ratio`·base_lr
    at `total`; fp32 arithmetic, a 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * frac))
    return base_lr * warm * cos


def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0):
    """Returns (new_params, new_opt_state, metrics).  Grad-norm clipping is
    global; weight decay is decoupled (AdamW).  Nothing is updated in
    place: the caller copies `new_params` into its parameters."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    new_p, new_mu, new_nu = [], [], []
    for g, mu, nu, p in zip(grads, opt_state["mu"], opt_state["nu"], params):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        step_ = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        step_ = step_ + weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * step_).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    return (new_p, {"mu": new_mu, "nu": new_nu, "count": count},
            {"grad_norm": gnorm, "lr": torch.as_tensor(lr)})
