"""What the dry-run tests run in each rank of a real gloo world (torch,
numpy and repro_torch only, never JAX): a reduced cell's step on CPU
tensors, counted as the dry run counts it on meta tensors."""
from __future__ import annotations

import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import InputShape, input_specs
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import resolve, use_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_mod


def cell_cfg(arch: str, overrides: dict):
    cfg = reduced(ARCHS[arch])
    ssm = overrides.get("ssm")
    over = {k: v for k, v in overrides.items() if k != "ssm"}
    if ssm:
        over["ssm"] = cfg.ssm.__class__(**{**cfg.ssm.__dict__, **ssm})
    return cfg.replace(**over)


def real_batch(cfg, shape: InputShape, data_n: int, seed: int = 0) -> dict:
    """A global batch of `input_specs`' keys, shapes and dtypes with data
    a step can take: token ids in the vocabulary, positions from 0, every
    row's pages its own (pool-local ids after the NULL page), decode rows
    at the context their page table holds."""
    g = torch.Generator().manual_seed(seed)
    pools, _, np_ = D._pool_layout(cfg, shape, data_n)
    specs = input_specs(cfg, shape, pages_per_seq=None if shape.kind ==
                        "train" else np_)
    b, s = shape.global_batch, shape.seq_len
    out = {}
    for key, spec in specs.items():
        if key in ("inputs", "labels") and spec.dtype == torch.int32:
            out[key] = torch.randint(0, cfg.vocab_size, tuple(spec.shape),
                                     generator=g, dtype=torch.int32)
        elif key == "inputs":
            out[key] = torch.randn(tuple(spec.shape), generator=g).to(
                spec.dtype)
        elif key == "page_table":
            per_pool = b // pools
            row = torch.arange(b)[:, None] % per_pool
            out[key] = (1 + row * np_ + torch.arange(np_)[None]).to(
                torch.int32)
        elif key in ("context_lens", "query_lens"):
            ctx = s if shape.kind != "decode" else np_ * cfg.page_size
            out[key] = torch.full((b,), ctx, dtype=torch.int32)
        elif key == "positions":
            last = spec.shape[-1]
            if shape.kind == "decode":
                pos = torch.full((b, 1), np_ * cfg.page_size - 1)
            else:
                pos = torch.arange(last)[None].expand(b, last)
            pos = pos.to(torch.int32)
            out[key] = pos[None].expand(3, *pos.shape).contiguous() \
                if spec.ndim == 3 else pos.contiguous()
    return out


def counts(count) -> dict:
    return {"flops": int(count.flops), "aten_flops": int(count.aten_flops),
            "bytes": int(count.total_bytes),
            "collectives": dict(count.collectives),
            "kernels": {k: list(v) for k, v in count.kernels.items()}}


def count_rank(rank: int, world: int, cells: list) -> dict:
    """Every cell's counted step on this rank of the (data 2, model 2)
    mesh, on CPU tensors: the counts, and what the step returned (the
    train loss, or this rank's block of the logits with its vocabulary
    range)."""
    torch.set_num_threads(1)
    mesh = mesh_mod.make_test_mesh()
    out = {}
    for name, (arch, over, kind, b, s) in cells.items():
        cfg = cell_cfg(arch, over)
        shape = InputShape(name, s, b, kind)
        batch = real_batch(cfg, shape, mesh.shape["data"])
        got = D.count_cell(cfg, shape, mesh, multi_pod=False,
                           device="cpu", batch=batch)
        res = counts(got["count"])
        if kind == "train":
            res["loss"] = float(got["output"][1]["loss"])
        else:
            with use_rules(mesh, D.rules_for(cfg, shape, False)):
                v_axes = resolve((cfg.vocab_size,), "vocab")[0]
                res["vocab"] = spmd.rank_range(cfg.vocab_size, v_axes)
            res["logits"] = got["output"][0].numpy()
        res["coord"] = dict(mesh.coord)
        out[name] = res
    return out
