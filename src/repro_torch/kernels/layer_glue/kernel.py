"""The packed serving step's per-layer glue: the ctypes wrappers over
`csrc/layer_glue.cu`, their launch counters, and their plain PyTorch
versions.

  add_rms_norm(x, delta, scale, eps) -> (h, x_new)
      x_new = x + delta in x's dtype (delta None: x_new is x), h =
      `rms_norm(x_new)`; x, delta [..., d] contiguous, scale [d].
  rope_write_kv(q, k, v, positions, freqs, k_pages, v_pages, write_index,
                *, style, sections=None) -> q_rot
      q [T, Hq, D], k / v [T, Hkv, D] (views of the QKV output: any token
      stride, heads of D contiguous elements); positions [T] ("rope") or
      [3, T] ("mrope": t / h / w rows), integers; freqs [D / 2] fp32, the
      step's `rope_frequencies` (unread for "none"); k_pages / v_pages
      this layer's [Hkv, G, P, ps, D] (written in place); write_index the
      step's `kv_cache.write_index` (src, dest, live), each [T].  Returns
      q rotated, a new contiguous [T, Hq, D]; k rotated and v are written
      into the pages as `scatter_kv` writes them.  "none" (musicgen)
      rotates nothing: q is copied, k and v written.
  silu_mul(gate, up) -> h
      `F.silu(gate) * up`; gate / up [..., ff] with unit element stride
      and any row stride (the halves of a fused gate_up product), h
      contiguous.

None of them replaces a Pallas kernel: the reference runs these
functions inside XLA's fusions (`repro/models/layers.py` `rms_norm`,
`apply_rope` / `apply_mrope`, `mlp`; `repro/core/paged/kv_cache.py`
`write_pages`), where the port ran chains of small eager operations.

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version; a meta tensor returns empty outputs
(and rope_write_kv leaves the pages alone).  Every route records the
kernel's work (`roofline.analysis`).  Each wrapper call that launches
adds one to its `LAUNCHES` entry and one to its device kernel's
`KERNEL_LAUNCHES` entry.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.paged.kv_cache import scatter_kv
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    _plain, _ptr, _raise_on, _record, _route, _stream,
)
from repro_torch.models import layers as L
from repro_torch.roofline import analysis

NORM = "add_rms_norm"
ROPE = "rope_write_kv"
GATE = "silu_mul"
_LIB_NAME = "layer_glue"
STYLES = {"rope": 0, "mrope": 1, "none": 2}
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: dict[str, int] = {NORM: 0, ROPE: 0, GATE: 0}
KERNEL_LAUNCHES: dict[str, int] = {"add_rms_norm_kernel": 0,
                                   "rope_write_kv_kernel": 0,
                                   "silu_mul_kernel": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _count(name: str) -> None:
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES[f"{name}_kernel"] += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_BOUND: dict[int, ctypes.CDLL] = {}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ at first use."""
    lib = _build.load(_LIB_NAME)
    if id(lib) not in _BOUND:
        lib.add_rms_norm.argtypes = [_P] * 5 + [_I, _I, ctypes.c_float, _I,
                                                _P]
        lib.rope_write_kv.argtypes = ([_P] * 3 + [_LL] * 3 + [_P, _LL, _LL]
                                      + [_P] * 3 + [_LL] + [_P] * 4
                                      + [_I] * 8 + [_P])
        lib.silu_mul.argtypes = [_P] * 3 + [_I, _I, _LL, _LL, _I, _P]
        for f in (lib.add_rms_norm, lib.rope_write_kv, lib.silu_mul):
            f.restype = _I
        _BOUND[id(lib)] = lib
    return lib


def _check_dtypes(name: str, ref: torch.Tensor, **tensors) -> None:
    if ref.dtype not in DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 only, got {ref.dtype}")
    for what, t in tensors.items():
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, must be "
                            f"{ref.dtype}")


def _check_contiguous(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs a contiguous "
                             f"{what} (strides {t.stride()})")


# ---------------------------------------------------------------------------
# add_rms_norm
# ---------------------------------------------------------------------------


def add_rms_norm_plain(x: torch.Tensor, delta: torch.Tensor | None,
                       scale: torch.Tensor, eps: float):
    """(rms_norm(x + delta), x + delta), the eager ops of the step."""
    x_new = x if delta is None else x + delta
    return L.rms_norm(x_new, scale, eps), x_new


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor | None,
                 scale: torch.Tensor, eps: float):
    """(h, x_new): x_new = x + delta rounded to x's dtype (x itself where
    delta is None), h = `rms_norm(x_new, scale, eps)`."""
    d = x.shape[-1]
    extra = {} if delta is None else {"delta": delta}
    _check_dtypes(NORM, x, scale=scale, **extra)
    if scale.shape != (d,) or (delta is not None and delta.shape != x.shape):
        raise ValueError(f"{NORM}: x {tuple(x.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, "
                         f"scale {tuple(scale.shape)}: delta must match x, "
                         f"scale be [d]")
    route = _route(NORM, x, scale, *extra.values())
    rows = x.numel() // d if d else 0
    _record(NORM, analysis.add_rms_norm_work, rows=rows, d=d,
            e=x.element_size(), add=delta is not None)
    if route == "meta":
        return torch.empty_like(x), x if delta is None else torch.empty_like(x)
    if route == "cpu":
        return _plain(add_rms_norm_plain, x, delta, scale, eps)
    _check_contiguous(NORM, x=x, scale=scale, **extra)
    h = torch.empty_like(x, memory_format=torch.contiguous_format)
    x_new = x if delta is None else torch.empty_like(h)
    with torch.cuda.device(x.device):
        rc = library().add_rms_norm(
            _ptr(x), None if delta is None else _ptr(delta), _ptr(scale),
            _ptr(h), None if delta is None else _ptr(x_new), rows, d,
            float(eps), int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(rc, NORM)
    _count(NORM)
    return h, x_new


# ---------------------------------------------------------------------------
# rope_write_kv
# ---------------------------------------------------------------------------


def rope_write_kv_plain(q, k, v, positions, freqs, k_pages, v_pages,
                        write_index, *, style: str, sections=None):
    """The eager ops of the step: `apply_rope` / `apply_mrope` of q and k
    at `freqs`, both page writes (`scatter_kv`); returns q rotated,
    contiguous."""
    if style == "rope":
        q = L.apply_rope(q, positions, freqs=freqs)
        k = L.apply_rope(k, positions, freqs=freqs)
    elif style == "mrope":
        q = L.apply_mrope(q, positions, None, sections, freqs=freqs)
        k = L.apply_mrope(k, positions, None, sections, freqs=freqs)
    scatter_kv(k_pages, k.transpose(0, 1), write_index)
    scatter_kv(v_pages, v.transpose(0, 1), write_index)
    return q.contiguous()


def _check_rope(q, k, v, positions, freqs, k_pages, v_pages, write_index,
                style, sections) -> None:
    if style not in STYLES:
        raise ValueError(f"{ROPE}: style {style!r} is none of {list(STYLES)}")
    _check_dtypes(ROPE, q, k=k, v=v, k_pages=k_pages, v_pages=v_pages)
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{ROPE}: q {tuple(q.shape)} / k {tuple(k.shape)} "
                         f"/ v {tuple(v.shape)} must be [T, Hq, D] / "
                         f"[T, Hkv, D]")
    t, _, d = q.shape
    if d % 2:
        raise ValueError(f"{ROPE}: head dim {d} must be even")
    for name, pages in (("k_pages", k_pages), ("v_pages", v_pages)):
        if pages.ndim != 5 or pages.shape[0] != k.shape[1] \
                or pages.shape[4] != d:
            raise ValueError(f"{ROPE}: {name} {tuple(pages.shape)} must be "
                             f"[Hkv={k.shape[1]}, G, P, ps, D={d}]")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{ROPE}: k_pages {tuple(k_pages.shape)} and "
                         f"v_pages {tuple(v_pages.shape)} differ")
    src, dest, live = write_index
    if src.shape != (t,) or dest.shape != (t,) or live.shape != (t,) \
            or src.dtype != torch.int64 or dest.dtype != torch.int64 \
            or live.dtype != torch.bool:
        raise ValueError(f"{ROPE}: write_index must be (src, dest int64, "
                         f"live bool), each [T={t}] (one pool)")
    if style == "none":
        return
    want = (t,) if style == "rope" else (3, t)
    if positions.shape != want or positions.dtype.is_floating_point:
        raise ValueError(f"{ROPE}: positions {tuple(positions.shape)} "
                         f"{positions.dtype} must be integer {want}")
    if freqs.shape != (d // 2,) or freqs.dtype != torch.float32:
        raise ValueError(f"{ROPE}: freqs {tuple(freqs.shape)} {freqs.dtype} "
                         f"must be float32 [D/2={d // 2}]")
    if style == "mrope" and (sections is None or len(sections) != 3
                             or sum(sections) != d // 2):
        raise ValueError(f"{ROPE}: M-RoPE sections {sections} must be 3 "
                         f"summing to D/2={d // 2}")


def rope_write_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor | None, freqs: torch.Tensor | None,
                  k_pages: torch.Tensor, v_pages: torch.Tensor, write_index,
                  *, style: str, sections=None) -> torch.Tensor:
    """q rotated [T, Hq, D] (a new tensor); k rotated and v written into
    this layer's pages at `write_index` (module docstring)."""
    _check_rope(q, k, v, positions, freqs, k_pages, v_pages, write_index,
                style, sections)
    t, hq, d = q.shape
    hkv = k.shape[1]
    src, dest, live = write_index
    rope_in = () if style == "none" else (positions, freqs)
    route = _route(ROPE, q, k, v, k_pages, v_pages, src, dest, live,
                   *rope_in)
    _record(ROPE, analysis.rope_write_kv_work, t=t, hq=hq, hkv=hkv, d=d,
            e=q.element_size(), style=style, written=t)
    if route == "meta":
        return torch.empty((t, hq, d), dtype=q.dtype, device=q.device)
    if route == "cpu":
        return _plain(rope_write_kv_plain, q, k, v, positions, freqs,
                      k_pages, v_pages, write_index, style=style,
                      sections=sections)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1 or x.stride(1) != d:
            raise ValueError(f"{ROPE}: {name} needs heads of D={d} "
                             f"contiguous elements (strides {x.stride()})")
    _check_contiguous(ROPE, k_pages=k_pages, v_pages=v_pages)
    if style == "none":
        pos_ptr, pos_ts, pos_rs, f_ptr = None, 0, 0, None
    else:
        positions = positions.to(torch.int64)
        _check_contiguous(ROPE, freqs=freqs)
        pos_ptr, pos_ts = _ptr(positions), positions.stride(-1)
        pos_rs = positions.stride(0) if style == "mrope" else 0
        f_ptr = _ptr(freqs)
    s0, s1 = (sections[0], sections[1]) if style == "mrope" else (0, 0)
    out = torch.empty((t, hq, d), dtype=q.dtype, device=q.device)
    rows_per_head = k_pages[0].numel() // d
    with torch.cuda.device(q.device):
        rc = library().rope_write_kv(
            _ptr(q), _ptr(k), _ptr(v), q.stride(0), k.stride(0), v.stride(0),
            pos_ptr, pos_ts, pos_rs, f_ptr, _ptr(k_pages), _ptr(v_pages),
            rows_per_head, _ptr(src), _ptr(dest), _ptr(live), _ptr(out), t,
            hq, hkv, d, STYLES[style], s0, s1,
            int(q.dtype == torch.bfloat16), _stream(q))
    _raise_on(rc, ROPE)
    _count(ROPE)
    return out


# ---------------------------------------------------------------------------
# silu_mul
# ---------------------------------------------------------------------------


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The SwiGLU gate as the eager step computes it."""
    return F.silu(gate) * up


def _rows(name: str, x: torch.Tensor, ff: int) -> torch.Tensor:
    """x [..., ff] as a [rows, ff] view (unit element stride, one row
    stride), or ValueError."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: needs unit element stride "
                         f"(strides {x.stride()})")
    try:
        return x.view(-1, ff)
    except RuntimeError as err:
        raise ValueError(f"{name}: rows of {tuple(x.shape)} at strides "
                         f"{x.stride()} have no single row stride") from err


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """`F.silu(gate) * up`, contiguous, in gate's dtype."""
    _check_dtypes(GATE, gate, up=up)
    if gate.shape != up.shape:
        raise ValueError(f"{GATE}: gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} differ")
    ff = gate.shape[-1]
    route = _route(GATE, gate, up)
    rows = gate.numel() // ff if ff else 0
    _record(GATE, analysis.silu_mul_work, rows=rows, ff=ff,
            e=gate.element_size())
    if route == "meta":
        return torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    if route == "cpu":
        return _plain(silu_mul_plain, gate, up)
    g2, u2 = _rows(GATE, gate, ff), _rows(GATE, up, ff)
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    with torch.cuda.device(gate.device):
        rc = library().silu_mul(
            _ptr(g2), _ptr(u2), _ptr(out), rows, ff, g2.stride(0),
            u2.stride(0), int(gate.dtype == torch.bfloat16), _stream(gate))
    _raise_on(rc, GATE)
    _count(GATE)
    return out
