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

The reference's v5e production mesh and its (data, model) training mesh
wait for the port's distributed training.
"""
from __future__ import annotations

import multiprocessing
import queue
import time
import traceback

import torch.distributed as dist

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
