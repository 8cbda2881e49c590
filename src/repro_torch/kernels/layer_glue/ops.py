"""Host layer around the per-layer glue kernels: what the packed step
computes once a step for them.

`step_rope` gives every attention layer of a packed step the token
positions and the RoPE frequencies it rotates by.  The frequencies are
`rope_frequencies` of the model (the expression the plain ops evaluated
in every call), computed once a step and never inside the kernel, and
the positions are the step's [1, T] (or M-RoPE's [3, 1, T]) as a view of
T tokens.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def step_rope(cfg: ModelConfig, positions: torch.Tensor):
    """(positions [T] or [3, T] for "mrope", freqs [D / 2] fp32 or None
    for "none") of a packed step's positions [1, T] / [3, 1, T]."""
    if cfg.rope_style == "none":
        return None, None
    tokens = positions[:, 0] if positions.ndim == 3 else positions[0]
    return tokens, L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                      positions.device)
