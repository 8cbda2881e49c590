"""Small shared utilities."""
from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def next_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()


def global_norm(tensors) -> torch.Tensor:
    """fp32 L2 norm over every element of a list of tensors (0-d)."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    return torch.sqrt(torch.sum(torch.stack(sq)))
