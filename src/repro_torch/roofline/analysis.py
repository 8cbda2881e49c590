"""Roofline terms of one rank's step, counted while the step runs.

The reference compiles each dry-run cell with XLA and reads its cost
analysis and the collectives of its HLO text.  The port has no compiled
program to read: it runs the step once, eagerly (on meta tensors in the
dry run: shapes and dtypes, no data), and counts what the step does
while it runs:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the aten ops
    (matmuls, convolutions), plus each hand-written kernel's work, which
    its wrapper records (`record_kernel`): a ctypes launch is no aten op;
  * bytes: every aten op's tensor inputs and outputs (`_BytesMode`, a
    `TorchDispatchMode`), views and allocations skipped, plus the
    kernels' recorded bytes;
  * collective bytes by kind: recorded by the port's own collective
    helpers (`record_collective`; a dispatch mode does not see
    `torch.distributed` calls), each the bytes of its result, the
    reference's convention;
  * memory: every storage an op creates is tracked until it is freed
    (`weakref.finalize`), and the peak of their sum is the step's
    temporaries, outputs included; the arguments (state, cache, batch)
    are counted by the caller (`storage_bytes`).

A wrapper that runs its kernel's plain PyTorch version (CPU tensors)
runs it inside `uncounted()`, so a CPU rank counts what a meta or CUDA
rank counts: the kernel's work, not its stand-in's.  The kernels' work
formulas (`*_work`) are the ones `chip_smoke.py` bounds each kernel
with; a wrapper gives them what its shapes say (every page of a page
table live, every key of a `kv_len` live): a meta tensor has no data.

Eager execution counts every layer, so a full-depth count is exact; the
reference's two-depth extrapolation (`extrapolate`) and its analytic
xLSTM scan corrections are kept as plain arithmetic.

Terms (seconds a step, per rank, at the H100 data-sheet rates of
`roofline.hw`):
  compute    = flops / PEAK_FLOPS_BF16
  memory     = bytes / HBM_BW
  collective = collective bytes / COLLECTIVE_BW
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)

from repro_torch.roofline import hw

# ---------------------------------------------------------------------------
# the kernels' work: (FLOPs, bytes), each input read once, each output
# written once
# ---------------------------------------------------------------------------

def elem_size(dtype) -> int:
    """Bytes of one element of a torch dtype or a dtype name."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype, device="meta").element_size()


def bound_ms(flops: float, nbytes: float, peak: float,
             hbm: float = hw.HBM_BW) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of bytes / HBM rate and
    FLOPs / peak."""
    t_bytes = nbytes / hbm * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live(ctx, tile: int) -> int:
    """Keys the paged kernels stream for contexts `ctx`: whole tiles."""
    return sum(-(-int(c) // tile) * tile for c in ctx)


def _causal_keys(ctx, qlens) -> int:
    """Keys summed over the query rows of chunks of `qlens` tokens ending
    at contexts `ctx` (row i of a chunk starting at c - q sees c - q + i +
    1 keys)."""
    total = 0
    for c, q in zip(ctx, qlens):
        start = int(c) - int(q)
        total += int(q) * start + int(q) * (int(q) + 1) // 2
    return total


def paged_work(name: str, *, s: int, hq: int, hkv: int, d: int, e: int,
               ctx, tile: int, pt_numel: int, ctx_numel: int,
               nseg: int = 1, prefill=None) -> tuple[int, int]:
    """The paged-attention kernels' work.  Decode: S sequences of hq
    query heads over hkv KV heads of width d (e bytes an element), the
    contexts `ctx`, keys streamed in tiles of `tile`; `nseg` segments (C3;
    the partials are fp32).  name "paged_decode", "paged_decode_segmented",
    "segment_reduce", "paged_decode_segmented_merged" (or the pair
    "paged_decode_segmented+segment_reduce": the partials are workspace),
    or "paged_prefill_qblock" with `prefill` = (q_packed numel, contexts,
    query lengths, page-table numel, Q blocks)."""
    q_numel = s * hq * d
    live_kv = _live(ctx, tile)
    meta = pt_numel * 4 + ctx_numel * 4
    m = hq // hkv
    seg_out = s * hkv * nseg * (m * d + 2 * m) * 4
    kv = 2 * live_kv * hkv * d * e
    attend = 4 * hq * d * sum(int(c) for c in ctx)
    merge = 3 * s * hkv * nseg * m * d
    if name == "paged_decode":
        return attend, 2 * q_numel * e + kv + meta
    if name == "paged_decode_segmented":
        return attend, q_numel * e + kv + meta + seg_out
    if name == "segment_reduce":
        return merge, seg_out + q_numel * e
    if name in ("paged_decode_segmented_merged",
                "paged_decode_segmented+segment_reduce"):
        return attend + merge, 2 * q_numel * e + kv + meta
    if name != "paged_prefill_qblock":
        raise ValueError(f"unknown paged kernel {name!r}")
    qp_numel, pctx, qlens, ppt_numel, nqb = prefill
    nbytes = (2 * qp_numel * e + 2 * _live(pctx, tile) * hkv * d * e
              + ppt_numel * 4 + 2 * nqb * 4)
    return 4 * hq * d * _causal_keys(pctx, qlens), nbytes


def flash_work(*, b: int, sq: int, skv: int, hq: int, hkv: int, dk: int,
               dv: int, causal: bool, e: int, kv_len=None,
               q_offset: int = 0) -> tuple[int, int]:
    """The flash forward over b slices: q [b, sq, hq, dk], k / v [b, skv,
    hkv, dk / dv], query row i at position q_offset + i; `kv_len` (a
    length a slice, default skv) masks the keys past it.  FLOPs 2 (dk +
    dv) a live (query, key) pair a head; bytes: q read, o and the fp32
    lse written once a row, k and v read once for the live keys."""
    kvl = [skv] * b if kv_len is None else [min(int(n), skv) for n in kv_len]
    pairs = 0
    for n in kvl:
        if not causal:
            pairs += sq * n
            continue
        under = max(0, min(n - q_offset, sq))  # rows that see < n keys
        pairs += under * q_offset + under * (under + 1) // 2 \
            + (sq - under) * n
    rows = b * sq * hq
    nbytes = rows * (dk + dv) * e + rows * 4 + sum(kvl) * hkv * (dk + dv) * e
    return 2 * hq * pairs * (dk + dv), nbytes


def ssd_work(*, bsz: int, l: int, h: int, p: int, n: int, grp: int,
             q: int, e: int) -> tuple[int, int]:
    """The SSD chunked scan: FLOPs B H nc (2 Q^2 (N + P) + 4 Q N P);
    bytes: x, B, C (e bytes an element) and the fp32 dt, a_cum, s0 read
    once, y (fp32) and the final state written once."""
    flops = bsz * h * (l // q) * (2 * q * q * (n + p) + 4 * q * n * p)
    nbytes = (bsz * l * h * p * e + 2 * bsz * l * grp * n * e
              + 2 * bsz * l * h * 4 + 2 * bsz * h * n * p * 4
              + bsz * l * h * p * 4)
    return flops, nbytes


def mlstm_work(*, bsz: int, l: int, h: int, p: int, q: int,
               e: int) -> tuple[int, int]:
    """The chunked mLSTM: FLOPs B H nc (6 Q^2 P + 4 Q P^2) (q k^T, S v and
    the decayed sum of k within the chunk; q C and the k^T v update);
    bytes: q, k, v (e bytes an element), the fp32 gates ig, bcum, g and
    the initial state read once, h and the final state written once."""
    flops = bsz * h * (l // q) * (6 * q * q * p + 4 * q * p * p)
    state = bsz * h * (p * p + p + 1) * 4
    return flops, 4 * bsz * l * h * p * e + 3 * bsz * l * h * 4 + 2 * state


def moe_pair_work(*, rows: int, touched: int, d: int, ff: int,
                  e: int) -> tuple[int, int]:
    """The grouped GEMM pair of the expert SwiGLU (gate + up, then down)
    as one function: the touched experts' three weight matrices, xs read
    and ys written once (h between the launches is workspace); 2 rows x 3
    d ff FLOPs."""
    return 2 * rows * 3 * d * ff, touched * 3 * d * ff * e + 2 * rows * d * e


def grouped_gemm_work(*, rows: int, touched: int, k: int, n: int,
                      n_w: int, e: int) -> tuple[int, int]:
    """One grouped GEMM launch: rows x k against `n_w` [k, n] matrices of
    each of `touched` experts (2 for the fused gate + up, 1 for down)."""
    return (2 * rows * k * n * n_w,
            touched * n_w * k * n * e + rows * k * e + rows * n * e)


def mla_decode_work(*, ctx, h: int, r: int, rope: int,
                    e: int) -> tuple[int, int]:
    """The latent decode: each live cached row [latent | k_rope] read once
    (for both products), q read and o_lat written once; 2 H (D + r)
    FLOPs a live row."""
    d = r + rope
    live = sum(int(c) for c in ctx)
    nbytes = live * d * e + len(ctx) * h * (d + r) * e + 8 * len(ctx)
    return live * h * 2 * (d + r), nbytes


def add_rms_norm_work(*, rows: int, d: int, e: int,
                      add: bool) -> tuple[int, int]:
    """The residual add and RMSNorm of `rows` rows of width d: x (and
    delta) read, h (and x_new) written, the scale read once; the add,
    the square-sum and the two products, 5 (4 without the add) FLOPs an
    element."""
    n = rows * d
    return (5 if add else 4) * n, (4 if add else 2) * n * e + d * e


def rope_write_kv_work(*, t: int, hq: int, hkv: int, d: int, e: int,
                       style: str, written: int) -> tuple[int, int]:
    """RoPE / M-RoPE of q and k and the K / V page write of t tokens, of
    which `written` write the pages: q read and written, each written
    row's k and v read and written, the positions (3 rows for M-RoPE),
    the frequencies and the write index (two int64 and a bool a token)
    read; 3 FLOPs an element rotated (4 products and 2 sums a pair), the
    cos / sin not counted."""
    rot = 0 if style == "none" else 3 * d * (t * hq + written * hkv)
    pos = {"rope": 8 * t + 2 * d, "mrope": 24 * t + 2 * d}.get(style, 0)
    return rot, 2 * t * hq * d * e + 4 * written * hkv * d * e + pos + 17 * t


def silu_mul_work(*, rows: int, ff: int, e: int) -> tuple[int, int]:
    """The SwiGLU gate silu(g) * u of rows x ff elements: g and u read, h
    written; 5 FLOPs an element (the negation, exp, sum, quotient and
    product)."""
    n = rows * ff
    return 5 * n, 3 * n * e


def sum_squares_work(*, elems: int, nbytes: int, n: int) -> tuple[int, int]:
    """The sums of squares of n tensors of `elems` elements in `nbytes`
    bytes: each element read once, squared and added (2 FLOPs), n fp32
    sums written."""
    return 2 * elems, nbytes + 4 * n


def adamw_work(*, elems: int, p_bytes: int, g_bytes: int) -> tuple[int, int]:
    """The AdamW update of `elems` parameters of p_bytes each with
    gradients of g_bytes: the parameter and both fp32 moments read and
    written, the gradient read; 17 FLOPs an element (the clip product, 3
    for the first moment, 4 for the second, the two bias-correction
    quotients, the square root, the eps sum, the quotient, 2 for the
    weight decay, 2 for the step)."""
    return 17 * elems, elems * (2 * p_bytes + g_bytes + 16)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_ACTIVE: list["StepCounter"] = []  # process-wide: backward threads record

_EMPTY = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}
_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")
_KIND: dict = {}  # op -> "view" | "inplace" | "fresh" | "skip"


def _op_kind(func) -> str:
    kind = _KIND.get(func)
    if kind is None:
        returns = func._schema.returns
        if func.namespace in _SKIP_NAMESPACES:
            kind = "skip"
        elif any(r.alias_info is not None and r.alias_info.is_write
                 for r in returns):
            kind = "inplace"
        elif any(r.alias_info is not None for r in returns):
            kind = "view"
        else:
            kind = "fresh"
        _KIND[func] = kind
    return kind


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in _pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Counts each aten op's tensor bytes into `counter` and tracks the
    storages of its fresh outputs."""

    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _op_kind(func)
        if kind in ("view", "skip"):
            return out
        if func not in _EMPTY:
            self.counter.bytes += _tensor_bytes((args, kwargs)) \
                + _tensor_bytes(out)
        if kind == "fresh":
            for t in _pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.counter._track(t)
        return out


@dataclasses.dataclass
class Count:
    """What a `StepCounter` saw: aten FLOPs and bytes, the kernels'
    records {name: [launches, flops, bytes]}, collective bytes by kind,
    and the peak of the storages made during the count."""
    aten_flops: int = 0
    bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    live_bytes: int = 0

    @property
    def kernel_flops(self) -> int:
        return sum(k[1] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(k[2] for k in self.kernels.values())

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    @property
    def total_bytes(self) -> int:
        return self.bytes + self.kernel_bytes

    @property
    def coll_bytes(self) -> int:
        return sum(self.collectives.values())

    def cost(self) -> "CellCost":
        return CellCost(float(self.flops), float(self.total_bytes),
                        float(self.coll_bytes),
                        {k: float(v) for k, v in self.collectives.items()})

    def triple(self) -> tuple:
        """(flops, bytes, collectives): `extrapolate`'s input."""
        return (float(self.flops), float(self.total_bytes),
                {k: float(v) for k, v in self.collectives.items()})


class StepCounter(Count):
    """Counts the calls inside it (`with StepCounter() as c: step()`).
    One counter is active at a time, in the whole process."""

    def __init__(self):
        super().__init__()
        self._ids: dict[int, weakref.finalize] = {}
        self._stack = None

    def _free(self, key: int, nbytes: int) -> None:
        self._ids.pop(key, None)
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._ids:
            return
        nbytes = st.nbytes()
        fin = weakref.finalize(st, self._free, key, nbytes)
        fin.atexit = False
        self._ids[key] = fin
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        if _ACTIVE:
            raise RuntimeError("a StepCounter is already counting")
        stack = contextlib.ExitStack()
        self._flop_mode = stack.enter_context(
            FlopCounterMode(display=False))
        stack.enter_context(_BytesMode(self))
        self._stack = stack
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._stack.close()
        self.aten_flops = int(self._flop_mode.get_total_flops())
        for fin in list(self._ids.values()):
            fin.detach()
        self._ids.clear()
        return False

    def fresh_bytes(self, tree) -> int:
        """The bytes of the distinct storages behind `tree`'s tensors that
        were made during the count (the step's outputs)."""
        seen, total = set(), 0
        for t in _pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) in self._ids and id(st) not in seen:
                    seen.add(id(st))
                    total += st.nbytes()
        return total

    def snapshot(self) -> Count:
        """The counts so far, as a plain `Count` (the tracking stops with
        the counter)."""
        return Count(self.aten_flops, self.bytes, dict(self.kernels),
                     dict(self.collectives), self.peak_bytes,
                     self.live_bytes)


def counting() -> bool:
    """Whether a `StepCounter` is counting (in any thread)."""
    return bool(_ACTIVE)


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """A kernel wrapper's launch (or its meta / plain stand-in): its work
    into the active counter, if any."""
    if _ACTIVE:
        k = _ACTIVE[0].kernels.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += int(flops)
        k[2] += int(nbytes)


def record_collective(kind: str, nbytes: int) -> None:
    """A collective's result bytes into the active counter, if any."""
    if _ACTIVE:
        c = _ACTIVE[0].collectives
        c[kind] = c.get(kind, 0) + int(nbytes)


@contextlib.contextmanager
def collective(kind: str, nbytes: int):
    """Around a `torch.distributed` call: its result bytes recorded
    (`record_collective`) and nothing inside counted (a backend's own
    copies, which a fake world does not make, are its transport)."""
    record_collective(kind, nbytes)
    with uncounted():
        yield


def uncounted():
    """A context in which nothing is counted: a kernel's plain version
    runs in it (its kernel's work is recorded instead)."""
    return _disable_current_modes() if _ACTIVE else contextlib.nullcontext()


def storage_bytes(*trees) -> int:
    """The bytes of the distinct storages behind the tensors of `trees`."""
    seen, total = set(), 0
    for t in _pytree.tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


# ---------------------------------------------------------------------------
# the reference's cell cost, extrapolation and scan corrections
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellCost:
    """Per-rank, per-step costs at full depth."""
    flops: float
    bytes_hbm: float
    coll_bytes: float
    coll_breakdown: dict
    corrected: bool = False

    def terms(self, *, peak: float = hw.PEAK_FLOPS_BF16,
              hbm: float = hw.HBM_BW,
              link: float = hw.COLLECTIVE_BW) -> dict:
        return {"compute_s": self.flops / peak,
                "memory_s": self.bytes_hbm / hbm,
                "collective_s": self.coll_bytes / link}

    def dominant(self, **rates) -> str:
        t = self.terms(**rates)
        return max(t, key=t.get)


def extrapolate(depth_costs: dict, full_units: float) -> CellCost:
    """depth_costs: {units: (flops, bytes, collectives by kind)} at two
    depths.  The linear model cost(u) = base + u * per_unit, evaluated at
    full_units."""
    (u1, c1), (u2, c2) = sorted(depth_costs.items())
    assert u2 > u1

    def lin(v1, v2):
        per = (v2 - v1) / (u2 - u1)
        base = v1 - u1 * per
        return max(base + full_units * per, 0.0)

    flops = lin(c1[0], c2[0])
    bytes_ = lin(c1[1], c2[1])
    kinds = set(c1[2]) | set(c2[2])
    breakdown = {k: lin(c1[2].get(k, 0), c2[2].get(k, 0)) for k in kinds}
    return CellCost(flops, bytes_, sum(breakdown.values()), breakdown)


def mlstm_chunk_scan_correction(*, batch_per_dev, seq, heads, head_dim,
                                chunk, n_layers):
    """The reference's per-device extra (flops, bytes) for the (nc - 1)
    chunkwise mLSTM scan bodies a layer that its cost analysis counts
    once.  The port's eager count needs none; kept as the reference's
    arithmetic."""
    b, q, h, p = batch_per_dev, chunk, heads, head_dim
    nc = seq // chunk
    body_flops = 6 * b * q * q * h * p + 4 * b * q * h * p * p \
        + 6 * b * q * q * h
    body_bytes = 4 * (4 * b * q * h * p + 2 * b * h * p * p + b * q * q * h)
    extra = max(nc - 1, 0) * n_layers
    return body_flops * extra, body_bytes * extra


def slstm_time_scan_correction(*, batch_per_dev, seq, d_model, num_heads,
                               n_layers):
    """The reference's per-device extra (flops, bytes) for the (S - 1)
    sLSTM steps its cost analysis counts once (the port needs none)."""
    b, d = batch_per_dev, d_model
    body_flops = 8 * b * d * d // num_heads + 24 * b * d
    body_bytes = 4 * (8 * b * d)
    extra = max(seq - 1, 0) * n_layers
    return body_flops * extra, body_bytes * extra
