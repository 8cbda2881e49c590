"""Fault-tolerant checkpoints of a flat {name: tensor} train state.  The
port of `repro.training.checkpoint`, with the same guarantees.

Layout: <dir>/step_<N>/
  manifest.json   {step, leaves {name: shape, dtype}, data_state, extra}
  tensors.pt      the tensors on the CPU (`torch.save`, bf16 kept as is)

  * atomic: written to step_<N>.tmp, then renamed; a crash mid-write never
    corrupts the latest valid checkpoint, and a leftover .tmp is ignored;
  * async: `AsyncCheckpointer.save_async` copies the state to the host on
    the caller's thread and writes it on a background thread;
  * keep_last_n garbage collection;
  * elastic restore: a mesh run saves whole tensors (every rank gathers
    its blocks, `trainer.whole_state_tensors`; one rank writes), so a
    checkpoint restores onto one device (`trainer.load_state_tensors`)
    or onto any mesh (then `trainer.place_train_state` cuts each rank's
    blocks), the reference's elastic restore.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import torch

from repro_torch.training.data import DataState


def save(ckpt_dir: str, tensors: dict[str, torch.Tensor], *, step: int,
         data_state: DataState | None = None, keep_last_n: int = 3,
         extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    host = {k: v.detach().cpu() for k, v in tensors.items()}
    torch.save(host, os.path.join(tmp, "tensors.pt"))
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in host.items()},
        "data_state": dataclasses.asdict(data_state) if data_state else None,
        "extra": extra or {},
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep_last_n)
    return final


def _gc(ckpt_dir: str, keep_last_n: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last_n]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, *, step: int | None = None):
    """Returns (tensors on the CPU, step, data_state)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tensors = torch.load(os.path.join(path, "tensors.pt"), weights_only=True)
    for k, meta in manifest["leaves"].items():
        t = tensors[k]
        if list(t.shape) != meta["shape"] or str(t.dtype) != meta["dtype"]:
            raise ValueError(f"{path}: {k} is {tuple(t.shape)} {t.dtype}, "
                             f"the manifest says {meta}")
    ds = manifest.get("data_state")
    return tensors, manifest["step"], DataState(**ds) if ds else None


class AsyncCheckpointer:
    """One in-flight save at a time; the host copy happens on the caller's
    thread (so training may update the parameters right after), the
    write on a background thread."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, ckpt_dir: str, tensors: dict[str, torch.Tensor], *,
                   step: int, data_state: DataState | None = None,
                   keep_last_n: int = 3) -> None:
        self.wait()
        host = {k: v.detach().to("cpu", copy=True)  # snapshot now
                for k, v in tensors.items()}

        def _work():
            self.last_path = save(ckpt_dir, host, step=step,
                                  data_state=data_state,
                                  keep_last_n=keep_last_n)

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()
