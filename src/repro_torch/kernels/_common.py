"""What every kernel wrapper shares: the mask value, the choice between
the CUDA kernel and the plain version, the launch plumbing, the
online-softmax step of the plain versions, and the within-chunk cumsum of
the chunked scans' log-decays (Mamba2's dt * A, mLSTM's log forget gate).

A wrapper given CUDA tensors launches its kernel on the current stream
and raises when the launch fails; given CPU tensors it runs its plain
version.  `_tile_update` is the Pallas kernels' `_flash_tile_update` in
PyTorch ops, with the same masking constants.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# head dims of the bf16 tensor-core attention kernels (flash forward, paged
# prefill): every head dim of the registry's attention models
MMA_HEAD_DIMS = (64, 128)


class LaunchLimitError(ValueError):
    """A shape inside the wrapper's inputs' contract that the CUDA kernel
    does not take (a head dim, a shared-memory footprint), raised before
    the launch.  A kernel-config sweep prices such a configuration at
    infinity; every other `ValueError` is a malformed input."""


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device, "
                             f"got {t.device} and {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 tensor-core kernels copy their operands with 16-byte
    cp.async: each must start on a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernel needs 16-byte aligned "
                             f"tensors (data_ptr {t.data_ptr():#x})")


def _check_mma(name: str, d: int, *tensors: torch.Tensor) -> None:
    """What the bf16 tensor-core attention kernels take: head dim 64 or
    128, and 16-byte aligned rows for their cp.async copies."""
    if d not in MMA_HEAD_DIMS:
        raise LaunchLimitError(f"{name}: head_dim {d} has no bf16 "
                               f"tensor-core kernel (head dims "
                               f"{MMA_HEAD_DIMS}); it is not sent to a "
                               f"slower one")
    _check_aligned(name, *tensors)


def _tile_update(q, k, v, mask, scale, acc, m, l):
    """One online-softmax tile step, `_flash_tile_update` of the Pallas
    kernel.  q [..., M, D] f32; k/v [..., tile, D]; mask [..., M, tile].
    A fully masked step leaves (acc, m, l) exactly unchanged, so visiting
    a tile the kernel skips changes nothing."""
    s = torch.einsum("...md,...td->...mt", q, k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
    p = torch.exp(torch.where(mask, s - m_safe[..., None], NEG_INF))
    alpha = torch.exp(torch.clamp(m - m_safe, max=0.0))
    alpha = torch.where(m <= NEG_INF, 0.0, alpha)
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("...mt,...td->...md", p.to(v.dtype).float(), v.float())
    return acc * alpha[..., None] + pv, m_new, l_new


def _init_state(shape, device):
    *lead, d = shape
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.full(lead, NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(lead, dtype=torch.float32, device=device))


def _finalize(acc, l, dtype):
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(dtype)


def _running_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive fp32 prefix sum along `dim`, added strictly left to
    right."""
    sums = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        sums.append(sums[-1] + x.select(dim, i))
    return torch.stack(sums, dim)


def chunk_cumsum(la: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 cumsum over axis 2 of la [B, nc, Q, H], added in the
    order of the reference's `jnp.cumsum` on the CPU (XLA's reduce-window
    rewrite): left to right within blocks of 16, each block then offset by
    the left-to-right sum of the blocks before it.  Every decay of the SSD
    and of the mLSTM is exp of a difference of these sums and multiplies
    terms as large as the output, so one rounding apart shows above the
    tests' tolerances (`torch.cumsum` adds in another order); in this
    order the sums equal the reference's bit for bit, on the card as on
    the CPU."""
    q = la.shape[2]
    if q <= 16 or q % 16:
        return _running_sum(la, 2)
    inner = _running_sum(la.unflatten(2, (q // 16, 16)), 3)
    tot = inner[:, :, :, -1]
    before = torch.cat([torch.zeros_like(tot[:, :, :1]),
                        _running_sum(tot, 2)[:, :, :-1]], 2)
    return (inner + before[:, :, :, None]).flatten(2, 3)
