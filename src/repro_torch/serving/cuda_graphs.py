"""The entries of the engine's executable cache: a serving step run
eagerly, or captured into a CUDA graph and replayed.

Port of the reference's static-shape executable cache
(`repro.serving.engine.Engine._get_fn`, which its docstring calls "the TPU
analog of CUDA-graph capture").  An entry takes the step's host metadata
as numpy arrays, and optionally device tensors (the packed step's
`prev_tokens`: the previous launch's sampled ids, still on the card), and
returns the step's device outputs (a tuple):

  EagerStep    uploads the arrays and runs the step's body on them and the
               device tensors: the CPU, the padded prefill, and
               `Engine(cuda_graphs=False)` on the card
  GraphedStep  on the card: the first call copies the arrays and the
               device tensors into static device buffers and runs the body
               eagerly (the warm-up; its result is the step's), then
               captures the body over those buffers into a
               `torch.cuda.CUDAGraph`, which does not execute; every later
               call copies into the same buffers (the host arrays through
               one pinned buffer, the device tensors by a device-to-device
               copy on the stream) and replays the graph.  Its outputs are
               static buffers that the next replay overwrites.  The
               buffers take the shapes of the first call's arrays (an
               M-RoPE model's [3, 1, T] positions as any other).

A capture that fails raises; nothing carries on eagerly.  The cyclic
garbage collector is off during a capture (`gc_paused`).

`TokenCopies` takes the packed step's sampled ids (and a speculative
step's accept counts) off the card without
waiting for them: each launch's ids go into one of two pinned host
buffers by an asynchronous copy queued right behind the launch, so the
async loop can replay the next step (which overwrites a graph's output
buffer) before it reads them.

The kernel wrappers count their launches on the host as they enqueue
them (`LAUNCHES`, `KERNEL_LAUNCHES`), so a capture counts launches that
never ran and a replay counts none.  `counted` records what the capture
added and takes it back; each replay adds it again (`add_counts`), so a
graphed run counts what an eager run of the same steps counts.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.layer_glue import kernel as GL
from repro_torch.kernels.mamba2 import kernel as SK
from repro_torch.kernels.mla_decode import kernel as AK
from repro_torch.kernels.mlstm import kernel as MK
from repro_torch.kernels.moe import kernel as GK
from repro_torch.kernels.optimizer import kernel as OK
from repro_torch.kernels.paged_attention import kernel as K

Counts = list[dict[str, int]]


def kernel_counters() -> Counts:
    """Every launch counter of the kernel wrappers."""
    return [K.LAUNCHES, K.KERNEL_LAUNCHES, FK.LAUNCHES, FK.KERNEL_LAUNCHES,
            SK.LAUNCHES, SK.KERNEL_LAUNCHES, MK.LAUNCHES, MK.KERNEL_LAUNCHES,
            GK.LAUNCHES, GK.KERNEL_LAUNCHES, AK.LAUNCHES, AK.KERNEL_LAUNCHES,
            GL.LAUNCHES, GL.KERNEL_LAUNCHES, OK.LAUNCHES, OK.KERNEL_LAUNCHES]


def counted(fn: Callable, counters: Counts | None = None):
    """Run `fn()` and return (its result, the counts it added), leaving
    the counters as they were before the call, even when it raises."""
    counters = kernel_counters() if counters is None else counters
    before = [dict(c) for c in counters]
    try:
        out = fn()
    finally:
        delta = [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
                 for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.clear()
            c.update(b)
    return out, delta


def add_counts(delta: Counts, counters: Counts | None = None) -> None:
    """Add a `counted` delta to the counters (one replay)."""
    counters = kernel_counters() if counters is None else counters
    for c, d in zip(counters, delta):
        for k, n in d.items():
            c[k] += n


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off for the block.  A collection
    inside a capture can destroy an unreachable engine's CUDA graphs,
    events or pinned buffers, CUDA calls that invalidate the capture
    (`cudaErrorStreamCaptureInvalidated`); `torch.cuda.graph` collects
    before a capture only under `force_cudagraph_gc`, off by default."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class EagerStep:
    """An entry that uploads the host arrays and runs the body."""

    def __init__(self, body: Callable[[dict], tuple], device: torch.device):
        self.body = body
        self.device = device

    def __call__(self, arrays: dict[str, np.ndarray],
                 device_inputs: dict[str, torch.Tensor] | None = None) \
            -> tuple:
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in arrays.items()}
        return self.body(batch | (device_inputs or {}))


class StaticInputs:
    """Static device buffers for a step's host arrays: one byte buffer on
    the card, each array a 16-byte aligned view of it, filled from one
    pinned host buffer by one asynchronous copy.  The pinned buffer is
    rewritten only after the previous copy out of it has finished."""

    ALIGN = 16

    def __init__(self, arrays: dict[str, np.ndarray], device: torch.device):
        spans, off = {}, 0
        for name, a in arrays.items():
            spans[name] = (off, a.nbytes, a.dtype, a.shape)
            off += -(-a.nbytes // self.ALIGN) * self.ALIGN
        self._host = torch.empty(off, dtype=torch.uint8, pin_memory=True)
        self._dev = torch.empty(off, dtype=torch.uint8, device=device)
        host = self._host.numpy()
        self.host = {n: host[o:o + nb].view(dt).reshape(shape)
                     for n, (o, nb, dt, shape) in spans.items()}
        self.tensors = {
            n: self._dev[o:o + nb].view(torch.from_numpy(
                np.empty(0, dt)).dtype).view(shape)
            for n, (o, nb, dt, shape) in spans.items()}
        self._copied = torch.cuda.Event()

    def upload(self, arrays: dict[str, np.ndarray]) -> None:
        # The only host wait of a replayed step's dispatch.  The copy it
        # waits for was queued at the start of this entry's previous step,
        # behind at most the step before that; the async loop keeps at
        # most one step in flight, and dispatches a step only after it
        # consumed the one before the in-flight step, so that copy has
        # started and the wait is the copy alone, never a step's compute.
        self._copied.synchronize()
        for name, a in arrays.items():
            dst = self.host[name]
            if a.shape != dst.shape or a.dtype != dst.dtype:
                raise ValueError(f"static input {name!r}: {a.dtype}"
                                 f"{a.shape} does not fit the captured "
                                 f"{dst.dtype}{dst.shape}")
            np.copyto(dst, a)
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()


class GraphedStep:
    """An entry captured into a CUDA graph at its first call and replayed
    after.  `pool` is the engine's graph memory pool, shared by all its
    graphs (they replay one at a time); `stream` the engine's side stream,
    on which the warm-up and the capture run (the cuBLAS workspace and the
    merged decode's arrival counters of that stream exist before the
    capture).  `stats` counts "captures" and "replays", and sums the host
    seconds of the captures themselves ("capture_s": recording and
    instantiating the graph, after the warm-up)."""

    def __init__(self, body: Callable[[dict], tuple], device: torch.device,
                 pool, stream: torch.cuda.Stream, stats: dict):
        self.body = body
        self.device = device
        self.pool = pool
        self.stream = stream
        self.stats = stats
        self.inputs: StaticInputs | None = None
        self.device_inputs: dict[str, torch.Tensor] = {}
        self.tensors: dict[str, torch.Tensor] = {}  # the body's batch
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple = ()
        self.delta: Counts = []

    def __call__(self, arrays: dict[str, np.ndarray],
                 device_inputs: dict[str, torch.Tensor] | None = None) \
            -> tuple:
        device_inputs = device_inputs or {}
        if self.inputs is None:
            self.inputs = StaticInputs(arrays, self.device)
            self.device_inputs = {k: torch.empty_like(v)
                                  for k, v in device_inputs.items()}
            self.tensors = self.inputs.tensors | self.device_inputs
        self.inputs.upload(arrays)
        if device_inputs.keys() != self.device_inputs.keys():
            raise ValueError(f"device inputs {sorted(device_inputs)} are "
                             f"not the captured {sorted(self.device_inputs)}")
        for name, t in device_inputs.items():
            dst = self.device_inputs[name]
            if t.shape != dst.shape or t.dtype != dst.dtype:
                raise ValueError(f"device input {name!r}: {t.dtype}"
                                 f"{tuple(t.shape)} does not fit the "
                                 f"captured {dst.dtype}{tuple(dst.shape)}")
            dst.copy_(t)  # on the stream: ordered after t's producer
        if self.graph is not None:
            self.graph.replay()
            add_counts(self.delta)
            self.stats["replays"] += 1
            return self.outputs
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.body(self.tensors)  # the warm-up: the result
        cur.wait_stream(self.stream)
        for t in out:
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with gc_paused(), torch.cuda.graph(graph, pool=self.pool,
                                               stream=self.stream):
                return self.body(self.tensors)

        t0 = time.perf_counter()
        self.outputs, self.delta = counted(capture)
        self.stats["capture_s"] += time.perf_counter() - t0
        cur.wait_stream(self.stream)
        self.graph = graph
        self.stats["captures"] += 1
        return out


class TokenCopies:
    """Two host int32 buffers of `shape` for the packed step's sampled
    ids ([S]; on a speculative engine [S, K+2]: the [S, K+1] verify tokens
    and num_emitted as the last column, so one copy carries both), used
    in turn, one per launch: `start` queues the copy of a launch's device
    ids into the next buffer and returns its index, `wait` blocks until
    that copy is done and returns the ids.  On the card the buffers are
    pinned and the copy is asynchronous, ordered on the stream right
    behind the launch, with an event recorded after it; so a later replay
    that overwrites the graph's output buffer cannot reach the copy, and
    `wait` waits for this launch alone.  On the CPU the copy is immediate.

    Two buffers serve the async loop, which holds at most two launches
    whose ids the host has not read: the one in flight and the one just
    dispatched.  A third `start` before the oldest `wait` raises, as does
    a `wait` on a buffer with no copy pending."""

    def __init__(self, shape: int | tuple[int, ...], device: torch.device):
        pin = device.type == "cuda"
        self.bufs = [torch.zeros(shape, dtype=torch.int32, pin_memory=pin)
                     for _ in range(2)]
        self.events = [torch.cuda.Event() if pin else None
                       for _ in range(2)]
        self.pending = [False, False]
        self.starts = 0  # copies started; buffer = starts % 2

    def start(self, toks: torch.Tensor) -> int:
        i = self.starts % 2
        if self.pending[i]:
            raise RuntimeError(f"token buffer {i} still holds ids nobody "
                               "read: more than two launches in flight")
        self.bufs[i].copy_(toks, non_blocking=True)
        if self.events[i] is not None:
            self.events[i].record()
        self.pending[i] = True
        self.starts += 1
        return i

    def wait(self, i: int) -> np.ndarray:
        if not self.pending[i]:
            raise RuntimeError(f"token buffer {i} has no copy pending")
        if self.events[i] is not None:
            self.events[i].synchronize()
        self.pending[i] = False
        return self.bufs[i].numpy().copy()
