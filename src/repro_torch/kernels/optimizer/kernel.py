"""The optimizer step's two multi-tensor kernels: the ctypes wrappers over
`csrc/optimizer.cu`, their launch counters, their host tables and their
plain PyTorch versions.

  sum_squares(tensors) -> sums
      sums fp32 [N]: each tensor's fp32 sum of its squared elements (the
      clip's global norm is the square root of their sum).  One launch.
  adamw(params, grads, mus, nus, *, scale, bc1, bc2, lr, b1, b2, eps,
        weight_decay) -> None
      The AdamW update of `training.optimizer.adamw_update`, in place:
      every parameter and its fp32 moments, from its gradient times the
      clip scale; scale, bc1, bc2 (the bias corrections) and lr are 0-d
      fp32 tensors on the parameters' device (a Python float or CPU 0-d
      lr is copied there).  One launch per (parameter dtype, gradient
      dtype) group: bf16 / bf16, fp32 / fp32 and bf16 / fp32 (the
      microbatched step's fp32 average of bf16 gradients).

Neither replaces a Pallas kernel: the reference's `global_norm`
(`repro/utils/misc.py`) and `adamw_update` (`repro/training/optimizer.py`)
are jnp under jit, which XLA fuses, where the port ran about a dozen
eager elementwise operations a tensor slice.

The kernels take a device table of their tensors (pointers, sizes and
each tensor's first chunk of `SUM_CHUNK` / `ADAMW_CHUNK` elements), built
on the host for each call (gradients are new tensors each step) and
copied with one H2D copy from pinned memory on the current stream.  A
CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version; a meta tensor returns empty outputs (adamw
writes nothing).  Every route records the kernels' work
(`roofline.analysis`).  Each launch adds one to its wrapper's `LAUNCHES`
entry and to its device kernel's `KERNEL_LAUNCHES` entry.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    _plain, _ptr, _raise_on, _record, _route, _stream,
)
from repro_torch.roofline import analysis
from repro_torch.utils import misc

SUM = "sum_squares"
ADAMW = "adamw"
_LIB_NAME = "optimizer"
SUM_CHUNK = 1 << 18  # elements a block of sum_squares_kernel
ADAMW_CHUNK = 1 << 16  # elements a block of adamw_kernel
# the plain versions' slices: no fp32 temporary outgrows one (a whole-tensor
# form makes 5 GB temporaries for each expert matrix of deepseek-v2)
NORM_CHUNK = 1 << 26  # elements a slice of one tensor's plain sum of squares
UPDATE_CHUNK = 1 << 26  # elements a slice of the plain update
DTYPES = (torch.float32, torch.bfloat16)
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
         (torch.bfloat16, torch.float32))

LAUNCHES: dict[str, int] = {SUM: 0, ADAMW: 0}
KERNEL_LAUNCHES: dict[str, int] = {"sum_squares_kernel": 0,
                                   "adamw_kernel": 0}


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
_F = ctypes.c_float
_BOUND: dict[int, ctypes.CDLL] = {}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ at first use."""
    lib = _build.load(_LIB_NAME)
    if id(lib) not in _BOUND:
        lib.sum_squares.argtypes = [_P, _I, _LL, _LL, _P, _P, _P]
        lib.adamw.argtypes = ([_P, _I, _LL, _LL, _I, _I] + [_P] * 4
                              + [_F] * 6 + [_P])
        for f in (lib.sum_squares, lib.adamw):
            f.restype = _I
        _BOUND[id(lib)] = lib
    return lib


# ---------------------------------------------------------------------------
# the host tables
# ---------------------------------------------------------------------------


def first_chunks(numels, chunk: int) -> tuple[list[int], int]:
    """(each tensor's first chunk, the number of chunks): tensor i covers
    chunks [first[i], first[i] + cdiv(numel[i], chunk)); an empty tensor
    has none."""
    firsts, total = [], 0
    for n in numels:
        firsts.append(total)
        total += misc.cdiv(n, chunk)
    return firsts, total


def sum_squares_table(tensors, chunk: int = SUM_CHUNK
                      ) -> tuple[np.ndarray, int]:
    """(int64 [4 N + 1], chunks): the rows (data pointer, numel, is_bf16,
    first chunk) of sum_squares_kernel, then its arrival counter (0)."""
    numels = [t.numel() for t in tensors]
    firsts, total = first_chunks(numels, chunk)
    table = np.zeros(4 * len(tensors) + 1, dtype=np.int64)
    rows = table[:-1].reshape(-1, 4)
    rows[:, 0] = [t.data_ptr() for t in tensors]
    rows[:, 1] = numels
    rows[:, 2] = [t.dtype == torch.bfloat16 for t in tensors]
    rows[:, 3] = firsts
    return table, total


def adamw_groups(params, grads) -> dict[tuple, list[int]]:
    """{(parameter dtype, gradient dtype): the indices of its tensors, in
    order}, in the order the groups first appear: one launch each."""
    groups: dict[tuple, list[int]] = {}
    for i, (p, g) in enumerate(zip(params, grads)):
        groups.setdefault((p.dtype, g.dtype), []).append(i)
    return groups


def adamw_table(params, grads, mus, nus, chunk: int = ADAMW_CHUNK
                ) -> tuple[np.ndarray, int]:
    """(int64 [N, 6], chunks): the rows (p, g, mu, nu, numel, first chunk)
    of one group's adamw_kernel launch."""
    numels = [p.numel() for p in params]
    firsts, total = first_chunks(numels, chunk)
    table = np.empty((len(params), 6), dtype=np.int64)
    for col, ts in enumerate((params, grads, mus, nus)):
        table[:, col] = [t.data_ptr() for t in ts]
    table[:, 4] = numels
    table[:, 5] = firsts
    return table, total


def _device_table(table: np.ndarray, device) -> torch.Tensor:
    """`table` on `device`: one H2D copy on the current stream from pinned
    memory.  The caching host allocator records the copy on the stream and
    hands the pinned block out again only once the copy has run, so the
    buffer stays alive as long as the copy needs it."""
    host = torch.empty(table.shape, dtype=torch.int64, pin_memory=True)
    host.numpy()[...] = table
    return host.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# sum_squares
# ---------------------------------------------------------------------------


def _sum_squares_one(t: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of t's squared elements (0-d); a tensor of more than
    NORM_CHUNK elements is squared and summed in slices of that size, so
    no fp32 copy of it is made whole."""
    if t.numel() <= NORM_CHUNK:
        return torch.sum(torch.square(t.float()))
    return torch.sum(torch.stack([torch.sum(torch.square(c.float()))
                                  for c in t.reshape(-1).split(NORM_CHUNK)]))


def sum_squares_plain(tensors) -> torch.Tensor:
    """[N] fp32: each tensor's eager fp32 sum of squares, stacked."""
    return torch.stack([_sum_squares_one(t) for t in tensors])


def sum_squares(tensors) -> torch.Tensor:
    """fp32 [N]: each tensor's fp32 sum of its squared elements, in
    `tensors`' order (module docstring)."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError(f"{SUM}: no tensors")
    for i, t in enumerate(tensors):
        if t.dtype not in DTYPES:
            raise TypeError(f"{SUM}: tensor {i} is {t.dtype}, not one of "
                            f"{DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"{SUM}: tensor {i} {tuple(t.shape)} is not "
                             f"contiguous (strides {t.stride()})")
    route = _route(SUM, *tensors)
    dev = tensors[0].device
    _record(SUM, analysis.sum_squares_work, elems=sum(
        t.numel() for t in tensors), nbytes=sum(
        t.numel() * t.element_size() for t in tensors), n=len(tensors))
    if route == "meta":
        return torch.empty(len(tensors), dtype=torch.float32, device=dev)
    if route == "cpu":
        return _plain(sum_squares_plain, tensors)
    table, total = sum_squares_table(tensors)
    with torch.cuda.device(dev):
        table_d = _device_table(table, dev)
        partials = torch.empty(max(total, 1), dtype=torch.float32,
                               device=dev)
        out = torch.empty(len(tensors), dtype=torch.float32, device=dev)
        rc = library().sum_squares(_ptr(table_d), len(tensors), SUM_CHUNK,
                                   total, _ptr(partials), _ptr(out),
                                   _stream(out))
    _raise_on(rc, SUM)
    _count(SUM)
    return out


# ---------------------------------------------------------------------------
# adamw
# ---------------------------------------------------------------------------


def _slices(t: torch.Tensor):
    """Views of `t`'s elements, flat, in slices of UPDATE_CHUNK."""
    return t.view(-1).split(UPDATE_CHUNK)


@torch.no_grad()
def adamw_plain(params, grads, mus, nus, *, scale, bc1, bc2, lr, b1, b2,
                eps, weight_decay) -> None:
    """The eager update: each parameter and its two moments, one tensor at
    a time, in slices of at most UPDATE_CHUNK elements (every slice runs
    the reference's elementwise expressions in its order, so the result is
    bit for bit the whole-tensor form's)."""
    for g, mu, nu, p in zip(grads, mus, nus, params):
        for gs, ms, ns, ps in zip(_slices(g), _slices(mu), _slices(nu),
                                  _slices(p)):
            gs = gs.to(torch.float32) * scale
            ms.copy_(b1 * ms + (1 - b1) * gs)
            ns.copy_(b2 * ns + (1 - b2) * torch.square(gs))
            step_ = (ms / bc1) / (torch.sqrt(ns / bc2) + eps)
            step_ = step_ + weight_decay * ps.to(torch.float32)
            ps.copy_((ps.to(torch.float32) - lr * step_).to(ps.dtype))


def _check_adamw(params, grads, mus, nus) -> None:
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError(f"{ADAMW}: {len(params)} parameters, {len(grads)} "
                         f"gradients, {len(mus)} / {len(nus)} moments")
    f32 = torch.float32
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        shape = p.shape
        if g.shape != shape or mu.shape != shape or nu.shape != shape:
            raise ValueError(f"{ADAMW}: tensor {i}: parameter "
                             f"{tuple(p.shape)}, gradient {tuple(g.shape)}, "
                             f"moments {tuple(mu.shape)} / {tuple(nu.shape)}")
        if (p.dtype, g.dtype) not in PAIRS or mu.dtype != f32 \
                or nu.dtype != f32:
            raise TypeError(f"{ADAMW}: tensor {i}: parameter {p.dtype}, "
                            f"gradient {g.dtype}, moments {mu.dtype} / "
                            f"{nu.dtype}: the pairs are {PAIRS}, the "
                            f"moments fp32")
        if not (p.is_contiguous() and g.is_contiguous()
                and mu.is_contiguous() and nu.is_contiguous()):
            raise ValueError(f"{ADAMW}: tensor {i} {tuple(shape)}: every "
                             f"parameter, gradient and moment must be "
                             f"contiguous")


def _device_scalar(name: str, x, device) -> torch.Tensor:
    """x as a 0-d fp32 tensor on `device`: a device tensor as it is (cast
    where it is not fp32), a Python number or CPU tensor by a non-blocking
    copy (nothing waits for the stream)."""
    if isinstance(x, torch.Tensor) and x.device == device:
        if x.numel() != 1:
            raise ValueError(f"{ADAMW}: {name} must hold one value, got "
                             f"{tuple(x.shape)}")
        return x.reshape(()).to(torch.float32)
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise ValueError(f"{ADAMW}: {name} is on {x.device}, the "
                         f"parameters on {device}")
    return torch.as_tensor(x, dtype=torch.float32).reshape(()).to(
        device, non_blocking=True)


def adamw(params, grads, mus, nus, *, scale, bc1, bc2, lr, b1: float,
          b2: float, eps: float, weight_decay: float) -> None:
    """The AdamW update in place (module docstring): one launch per
    (parameter dtype, gradient dtype) group on the card."""
    params, grads, mus, nus = (list(x) for x in (params, grads, mus, nus))
    if not params:
        return
    _check_adamw(params, grads, mus, nus)
    route = _route(ADAMW, *params, *grads, *mus, *nus)
    dev = params[0].device
    groups = adamw_groups(params, grads)
    for (pd, gd), idx in groups.items():
        _record(ADAMW, analysis.adamw_work,
                elems=sum(params[i].numel() for i in idx),
                p_bytes=pd.itemsize, g_bytes=gd.itemsize)
    if route == "meta":
        return
    kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if route == "cpu":
        _plain(adamw_plain, params, grads, mus, nus, **kw)
        return
    with torch.cuda.device(dev):
        scalars = [_device_scalar(n, kw[n], dev)
                   for n in ("scale", "bc1", "bc2", "lr")]
        # 1 - b1 and 1 - b2 in double, then rounded to fp32, as Python
        # computes them before PyTorch rounds the scalar
        consts = (b1, b2, 1 - b1, 1 - b2, eps, weight_decay)
        for (pd, gd), idx in groups.items():
            table, total = adamw_table(
                *([ts[i] for i in idx] for ts in (params, grads, mus, nus)))
            if total == 0:
                continue
            table_d = _device_table(table, dev)
            rc = library().adamw(
                _ptr(table_d), len(idx), ADAMW_CHUNK, total,
                int(pd == torch.bfloat16), int(gd == torch.bfloat16),
                *(_ptr(s) for s in scalars), *consts, _stream(table_d))
            _raise_on(rc, ADAMW)
            _count(ADAMW)
