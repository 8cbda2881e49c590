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


NORM_CHUNK = 1 << 26  # elements a slice of one tensor's sum of squares


def sum_squares(t: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of t's squared elements (0-d); a tensor of more than
    NORM_CHUNK elements is squared and summed in slices of that size, so
    no fp32 copy of it is made whole."""
    if t.numel() <= NORM_CHUNK:
        return torch.sum(torch.square(t.float()))
    return torch.sum(torch.stack([torch.sum(torch.square(c.float()))
                                  for c in t.reshape(-1).split(NORM_CHUNK)]))


def global_norm(tensors) -> torch.Tensor:
    """fp32 L2 norm over every element of a list of tensors (0-d)."""
    return torch.sqrt(torch.sum(torch.stack([sum_squares(t)
                                             for t in tensors])))
