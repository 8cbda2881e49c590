"""Token sampling (greedy / temperature / top-k / top-p) with per-request
counter-seeded random streams.

The contract is the JAX reference's (`repro/models/sampling.py`):

  1. **Greedy rows** (`temperature <= 0`) return `argmax(logits)` of the
     raw logits; their temperature divisor is clamped to 1.0.
  2. **Sampled rows** scale by temperature, then apply top-k (`k <= 0`
     disables), then top-p (the smallest descending-probability prefix
     whose mass reaches p; `p >= 1` disables), then draw from the
     survivors.  Boundary ties are all kept.
  3. **Randomness is a pure function of (engine seed, request stream id,
     tokens generated so far)**, independent of batch composition, slot
     or row placement.

The draw is Gumbel-max, `argmax(filtered + gumbel_noise)`, which is what
`jax.random.categorical` computes; the noise comes from a `torch.Generator`
on the logits' device seeded from the (seed, stream, n_generated)
counter.  The bits differ from JAX's threefry keys, so the tests feed both
sides the same injected noise.
"""
from __future__ import annotations

import numpy as np
import torch


def row_seed(seed: int, stream: int, n_generated: int) -> int:
    """64-bit generator seed for one draw of one request stream."""
    state = np.random.SeedSequence(
        [int(seed), int(stream), int(n_generated)]).generate_state(2,
                                                                   np.uint32)
    return (int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1)


def hot_rows(temperature) -> list[int]:
    """The rows that draw noise: temperature > 0 (host array [S])."""
    return [i for i, t in enumerate(temperature) if t > 0]


def gumbel_noise(seed: int, stream_ids, num_generated, vocab: int,
                 device, rows=None, out: torch.Tensor | None = None) \
        -> torch.Tensor:
    """[S, vocab] fp32 Gumbel(0, 1) noise, row i drawn from the generator
    seeded by (seed, stream_ids[i], num_generated[i]).  Only the rows in
    `rows` (default all) are drawn; the others are zero.  The host part
    of the sampler: it runs outside any captured step, into `out` when
    given (the engine's static noise buffer, zeroed first)."""
    n = len(stream_ids)
    if out is None:
        out = torch.zeros((n, vocab), dtype=torch.float32, device=device)
    else:
        out.zero_()
    tiny = torch.finfo(torch.float32).tiny
    for i in (range(n) if rows is None else rows):
        g = torch.Generator(device=device)
        g.manual_seed(row_seed(seed, stream_ids[i], num_generated[i]))
        u = torch.rand(vocab, generator=g, device=device).clamp_min_(tiny)
        out[i] = -torch.log(-torch.log(u))
    return out


def scaled_logits(logits: torch.Tensor, temperature: torch.Tensor):
    """Temperature scaling with the greedy divisor clamped to 1.0."""
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    return logits.float() / safe_t[:, None]


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep each row's `top_k` highest logits (ties at the k-th value are
    all kept); `top_k <= 0` disables the filter for that row."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(top_k[:, None].long() - 1, 0, v - 1)
    kth = torch.gather(sorted_desc, -1, idx)
    keep = (logits >= kth) | (top_k[:, None] <= 0)
    return torch.where(keep, logits, -torch.inf)


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter: keep the smallest descending-probability prefix
    whose cumulative mass reaches `top_p` (always at least the top-1;
    ties at the threshold logit are all kept); `top_p >= 1` disables."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep_sorted, sorted_desc, torch.inf).amin(-1)
    keep = (logits >= thresh[:, None]) | (top_p[:, None] >= 1.0)
    return torch.where(keep, logits, -torch.inf)


def filter_logits(logits, temperature, top_p, top_k) -> torch.Tensor:
    """The full pre-draw transform (scale -> top-k -> top-p)."""
    x = scaled_logits(logits, temperature)
    x = apply_top_k(x, top_k)
    return apply_top_p(x, top_p)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor,
                  noise: torch.Tensor | None) -> torch.Tensor:
    """One token per row of `logits` [S, V]: greedy rows take argmax of the
    RAW logits; sampled rows take argmax(filter_logits + noise), noise
    being that row's Gumbel draw (`gumbel_noise`).  `noise=None` is only
    valid when every row is greedy.  The device part of the sampler: no
    host read, so the packed step captures it.  Returns int32 [S]."""
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        return greedy.to(torch.int32)
    x = filter_logits(logits, temperature, top_p, top_k)
    drawn = torch.argmax(x + noise, dim=-1)
    return torch.where(temperature > 0, drawn, greedy).to(torch.int32)


def sample_rows(logits: torch.Tensor, seed: int, temperature, top_p, top_k,
                stream_ids, num_generated) -> torch.Tensor:
    """`sample_tokens` with per-row parameters given as HOST arrays [S]:
    the host decides which rows draw noise (temperature > 0) and seeds
    each from (seed, stream id, num_generated); greedy rows need no noise.
    The padded step's eager sampling dispatch.  Returns int32 [S] on the
    logits' device."""
    dev = logits.device
    hot = hot_rows(temperature)
    noise = gumbel_noise(seed, stream_ids, num_generated, logits.shape[-1],
                         dev, rows=hot) if hot else None
    return sample_tokens(
        logits, torch.as_tensor(temperature, dtype=torch.float32, device=dev),
        torch.as_tensor(top_p, dtype=torch.float32, device=dev),
        torch.as_tensor(top_k, dtype=torch.int32, device=dev), noise)
