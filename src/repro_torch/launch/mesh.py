"""Process groups for tensor- and expert-parallel serving (the torch side of
the reference's `launch/mesh.py`, whose meshes are named device axes).

A rank is a process.  The caller chooses the backend and nothing switches
it on its own: "gloo" for ranks on the CPU, or for several ranks sharing
one card (gloo copies a CUDA tensor through the host for each
collective), "nccl" for one card a rank.

    spawn_ranks(fn, world, backend="gloo", init_file=path, args=(...))

starts `world` processes with the `spawn` start method, joins them into
one `torch.distributed` world through a `file://` store at `init_file`
(a path that does not exist yet: no TCP port, so concurrent runs on one
host cannot collide), calls `fn(rank, world, *args)` in each and returns
the ranks' results in rank order.  Under `torchrun --nproc-per-node N`
the world comes from the environment instead:
`torch.distributed.init_process_group(backend)`, then `make_tp_group`.

Training runs on a named mesh of the world's ranks, the reference's
`jax.make_mesh`: `make_mesh((2, 2), ("data", "model"), device_type=...)`
over an initialised world (row-major: rank = data * M + model), its
`TrainMesh` holding the `DeviceMesh` and a process group for every set
of its axes; `make_test_mesh` the (2, 2) host mesh of the tests;
`make_production_mesh` the reference's v5e pod geometry, (data 16, model
16) or (pod 2, data 16, model 16), on a world of exactly 256 / 512 ranks.
The reference's `RECOMMENDED_XLA_FLAGS` are TPU compiler flags and have
no counterpart here.

`fake_world(n)` makes this process rank 0 of a world of n ranks that
exist in name only (torch's "fake" process-group backend: every
collective returns at once, its output untouched): the dry run builds
the production mesh over it with `device_type="cpu"` and runs one rank's
step on meta tensors, whose collectives move no data.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import multiprocessing
import queue
import time
import traceback

import torch.distributed as dist

from repro_torch.core.paged.kv_cache import ShardingError

# a rank that has not reported after this long fails the run
RANK_TIMEOUT_S = 1800.0


def make_tp_group(tp: int, *, backend: str):
    """The process group of `tp` ranks this rank serves in: the whole
    world when it has `tp` ranks, else the block of `tp` consecutive
    ranks holding this one (every rank must call it, in the same order:
    `new_group` is collective).  `backend` is that of the new groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_tp_group needs an initialised "
                           "torch.distributed world (spawn_ranks, or "
                           "torchrun and init_process_group)")
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"groups of tp={tp}")
    if world == tp:
        return dist.group.WORLD
    mine = None
    for start in range(0, world, tp):
        group = dist.new_group(list(range(start, start + tp)),
                               backend=backend)
        if start <= dist.get_rank() < start + tp:
            mine = group
    return mine


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A named mesh of the world's ranks.  `shape` maps each axis to its
    size (the reference's `Mesh.shape`), `coord` this rank's index along
    each; `group(axes)` is the process group of the ranks that share this
    rank's coordinates on every other axis, in row-major order of `axes`
    (which are given in mesh order)."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis_names: tuple
    shape: dict
    coord: dict
    groups: dict

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index over `axes`."""
        k = 0
        for a in axes:
            k = k * self.shape[a] + self.coord[a]
        return k

    def group(self, axes):
        return self.groups[tuple(a for a in self.axis_names if a in axes)]

    @property
    def world(self) -> int:
        return self.size(self.axis_names)


def make_mesh(shape, axes, *, device_type: str) -> TrainMesh:
    """The mesh of `shape` named `axes` over the initialised world (whose
    size must be the product of `shape`); every rank calls it, in the same
    order (`new_group` is collective).  `device_type` is that of the
    ranks' tensors ("cuda" or "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if not dist.is_initialized():
        raise ShardingError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            f"torch.distributed world of {math.prod(shape)} ranks: start "
            f"them with `torchrun --nproc-per-node {math.prod(shape)}` "
            f"(then init_process_group(backend)) or with spawn_ranks")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ShardingError(f"a {shape} mesh over {axes} needs "
                            f"{math.prod(shape)} ranks; the world has "
                            f"{world}")
    rank = dist.get_rank()
    coord, r = {}, rank
    for a, n in reversed(list(zip(axes, shape))):
        coord[a], r = r % n, r // n
    coord = {a: coord[a] for a in axes}  # in mesh order
    sizes = dict(zip(axes, shape))
    device_mesh = init_device_mesh(device_type, shape,
                                   mesh_dim_names=axes)
    groups = {(a,): device_mesh.get_group(a) for a in axes}
    # the multi-axis groups, subsets in a fixed order on every rank
    for k in range(2, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            if k == len(axes):
                groups[sub] = dist.group.WORLD
                continue
            rest = [a for a in axes if a not in sub]
            for fixed in itertools.product(*(range(sizes[a])
                                             for a in rest)):
                where = dict(zip(rest, fixed))
                ranks = [_rank_of({**where, **dict(zip(sub, c))}, axes,
                                  sizes)
                         for c in itertools.product(*(range(sizes[a])
                                                      for a in sub))]
                group = dist.new_group(sorted(ranks))
                if all(coord[a] == where[a] for a in rest):
                    groups[sub] = group
    return TrainMesh(device_mesh, axes, sizes, coord, groups)


def _rank_of(coord: dict, axes, sizes) -> int:
    r = 0
    for a in axes:
        r = r * sizes[a] + coord[a]
    return r


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cpu") -> TrainMesh:
    """A small mesh for host-rank tests (a world of prod(shape) ranks)."""
    return make_mesh(shape, axes, device_type=device_type)


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axes) of the reference's v5e production mesh: one 16 x 16
    pod, or two of them on a 'pod' axis that carries only data-parallel
    traffic."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> TrainMesh:
    """The production mesh over a world of exactly 256 (512 with
    `multi_pod`) ranks; any other world raises ShardingError."""
    shape, axes = production_mesh_shape(multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ShardingError(f"the production mesh {shape} over {axes} "
                            f"needs {n} ranks; the world has {world}")
    return make_mesh(shape, axes, device_type=device_type)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank `rank` of a world of `world` ranks over the
    "fake" backend (no other process exists; collectives return at once
    and leave their outputs as they are), for the calls inside; the world
    is destroyed after them.  Raises where a world is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a torch.distributed world is "
                           "already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, backend: str, init_file: str, inbox,
               results) -> None:
    try:
        # the work comes through a queue, not the process's arguments: a
        # spawn writes those into the child's pipe while the child imports
        # torch, one child at a time
        fn, args = inbox.get()
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank)
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world: int, *, backend: str, init_file: str,
                args: tuple = ()) -> list:
    """Run `fn(rank, world, *args)` in `world` spawned ranks of one
    `torch.distributed` world; returns their results in rank order.  `fn`
    and `args` are pickled (a module-level function, plain data); so is
    each result (keep CUDA tensors out of it: move them to the CPU).  A
    rank that raises, dies or outlasts RANK_TIMEOUT_S fails the call, with
    the rank's traceback, after every process has ended."""
    ctx = multiprocessing.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, backend, init_file, inbox,
                               results))
             for rank in range(world)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put((fn, args))
    got: dict[int, object] = {}
    failures = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(got) < world and not failures:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died without a word (a signal, a crash of
                # the interpreter), or the deadline
                failures = [f"rank {r} exited with code {p.exitcode}"
                            for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                if not failures and time.monotonic() > deadline:
                    failures.append(f"no result within {RANK_TIMEOUT_S:.0f}"
                                    f" s")
                continue
            if ok:
                got[rank] = value
            else:  # the others may wait on it in a collective: stop all
                failures.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            if failures or len(got) < world:  # a failure, or interrupted
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failures:
        raise RuntimeError("spawn_ranks: " + "\n".join(failures))
    return [got[rank] for rank in range(world)]
