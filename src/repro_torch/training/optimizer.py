"""AdamW and the cosine schedule as plain functions on lists of tensors.

The port of `repro.training.optimizer`.  The moments are fp32 whatever the
parameter dtype, and each update runs in fp32 and is cast back to the
parameter's dtype: no fp32 master copy, as in the reference.
`torch.optim.AdamW` keeps its moments in the parameter dtype, so for bf16
parameters it computes a different function.

The update is in place, as the reference's jitted update effectively is
(XLA reuses the donated buffers), and runs in two hand-written
multi-tensor kernels (`kernels/optimizer`): one launch for every
gradient's sum of squares (the clip's global norm), one launch per
(parameter dtype, gradient dtype) group for the update itself, which
makes no temporaries.  The clip scale, the bias corrections and the
learning rate stay 0-d device tensors: nothing of the update is read on
the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import spmd
from repro_torch.kernels.optimizer import kernel as OK


def adamw_init(params: list[torch.Tensor]) -> dict:
    """{"mu": [...], "nu": [...]} fp32 zeros like `params`, "count" 0.  On
    a training mesh each moment holds its parameter's block and carries
    its layout (`spmd.placement`)."""
    def zeros():
        out = []
        for p in params:
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if spmd.placement(p) is not None:
                spmd.set_placement(z, spmd.placement(p))
            out.append(z)
        return out

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


def global_norm(tensors) -> torch.Tensor:
    """fp32 L2 norm over every element of a list of tensors (0-d): the
    square root of the sum of each tensor's sum of squares, as the
    reference sums its leaves."""
    return torch.sqrt(torch.sum(OK.sum_squares(tensors)))


def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0, gnorm=None):
    """Updates `params` and the moments of `opt_state` in place and returns
    (params, opt_state with the new count, metrics).  Grad-norm clipping
    is global and computed first (`gnorm`, the gradients' global norm:
    given by a mesh trainer whose ranks hold blocks of them, else computed
    here); weight decay is decoupled (AdamW), elementwise, so a rank
    updates its blocks alone."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    OK.adamw(params, grads, opt_state["mu"], opt_state["nu"], scale=scale,
             bc1=bc1, bc2=bc2, lr=lr, b1=b1, b2=b2, eps=eps,
             weight_decay=weight_decay)
    return (params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                     "count": count},
            {"grad_norm": gnorm, "lr": torch.as_tensor(lr)})
