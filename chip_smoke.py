#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) and `nvcc`.  It imports nothing
of JAX and nothing of the JAX package.  Phases, each failing the run
(non-zero exit, no result line) on any error:

  1. device   the card's name and `nvidia-smi` name / power limit
  2. build    compile csrc/paged_attention.cu with nvcc (sm_90a)
  3. check    each of the four CUDA kernels against its plain PyTorch
              version on the card, at the serving main path's shapes
              (Hkv 3, group 3, D 64, page 16, 8 sequences with contexts
              0..2048, a 512-token prefill region with a resumed chunk),
              in fp32 with TF32 off (atol 1e-4) and bf16 (atol 2e-2: a
              bf16 output ulp near 1 is 7.8e-3, and p is rounded to bf16
              before p.V on both sides), plus a non-power-of-two page (24)
  4. time     median kernel time over CUDA events (L2 flushed before each
              launch) beside the plain version, a library yardstick and
              the bound (bytes at 3.35 TB/s or FLOPs at peak)
  5. serve    full-width smollm-135m (bf16, random seeded weights) serves
              8 requests (prompts 128-1024, 32 new tokens, max_seqs 8,
              chunked prefill) through the packed fused step; the kernel
              launch counters are zeroed just before and read just after
  6. diff     full width in fp32 (TF32 off): 3 greedy requests of 8 new
              tokens on the card (CUDA kernels) and on the CPU (plain
              versions), stepped in lockstep: identical tokens, logits
              within 5e-3

The line before the last is `nvidia-smi`'s name and power limit, the one
before that the kernels' JSON; the last line is the result JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
ARCH = "smollm-135m"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, H100 SXM
KERNEL_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode": "src/repro/kernels/paged_attention/kernel.py:169",
    "paged_decode_segmented": "src/repro/kernels/paged_attention/kernel.py:279",
    "segment_reduce": "src/repro/kernels/paged_attention/kernel.py:359",
    "paged_prefill_qblock": "src/repro/kernels/paged_attention/kernel.py:454",
}
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
DEVICE = "cuda"
DIFF_LOGIT_ATOL = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------


def decode_inputs(torch, dtype, ps, *, hkv=3, group=3, d=64,
                  ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
                  max_model_len=2048, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = len(ctx)
    np_ = -(-max_model_len // ps)
    p = s * np_ + 1
    q = torch.randn((s, hkv * group, d), generator=g).to(dtype)
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: s * np_].reshape(s, np_)
          + 1).to(torch.int32)
    dev = DEVICE
    return (q.to(dev), kp.to(dev), vp.to(dev), pt.to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def prefill_inputs(torch, tops, dtype, ps, *, hkv=3, group=3, d=64,
                   ms=8, block_q=16, seed=2):
    """The chunk region of a packed step: a fresh chunk of 200 tokens and
    a resumed chunk of 312 tokens at context 1312 (512 tokens), six empty
    chunk slots; q_packed / qb metadata as ops.paged_attention_prefill
    builds them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ctx = [200, 1312] + [0] * (ms - 2)
    qlens = [200, 312] + [0] * (ms - 2)
    t = 512
    np_ = -(-2048 // ps)
    p = ms * np_ + 1
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: ms * np_].reshape(ms, np_)
          + 1).to(torch.int32)
    qlens_t = torch.tensor(qlens, dtype=torch.int32)
    qsl = torch.cat([torch.zeros(1, dtype=torch.int32),
                     torch.cumsum(qlens_t, 0, dtype=torch.int32)])
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    nqb = t // block_q + ms
    qb_seq, qb_pos0, _, _ = tops.build_qblock_metadata(
        qsl, qlens_t, ctx_t, block_q=block_q, num_q_blocks=nqb)
    q_packed = torch.randn((nqb, hkv, block_q * group, d), generator=g).to(
        dtype)
    dev = DEVICE
    return dict(q_packed=q_packed.to(dev), k=kp.to(dev), v=vp.to(dev),
                qb_seq=qb_seq.to(dev), qb_pos0=qb_pos0.to(dev),
                pt=pt.to(dev), ctx=ctx_t.to(dev), block_q=block_q,
                group=group, qlens=qlens)


def tile_view(pages, tile):
    hkv, p, ps, d = pages.shape
    return pages.reshape(hkv, p, ps // tile, tile, d)


# ---------------------------------------------------------------------------
# one call per kernel (kernel wrapper or plain version, same inputs)
# ---------------------------------------------------------------------------


def kernel_calls(torch, K, dtype, ps, tile, tops):
    """({name: (kernel_fn, plain_fn)}, inputs) at the main path's shapes;
    both functions of a pair take the same tensors."""
    q, kp, vp, pt, ctx = decode_inputs(torch, dtype, ps)
    s, hq, d = q.shape
    hkv = kp.shape[0]
    group = hq // hkv
    kt, vt = tile_view(kp, tile), tile_view(vp, tile)
    num_tiles = pt.shape[1] * (ps // tile)
    nseg = min(16, num_tiles)
    tps = -(-num_tiles // nseg)
    scale = d ** -0.5
    qg = q.reshape(s, hkv, group, d).contiguous()
    qb = q.reshape(s, hq, 1, d).contiguous()
    seg_kw = dict(num_segments=nseg, tiles_per_segment=tps, scale=scale)
    parts = K.paged_decode_segmented(qg, kt, vt, pt, ctx, **seg_kw)
    pf = prefill_inputs(torch, tops, dtype, ps)
    pkt, pvt = tile_view(pf["k"], tile), tile_view(pf["v"], tile)
    pf_args = (pf["q_packed"], pkt, pvt, pf["qb_seq"], pf["qb_pos0"],
               pf["pt"], pf["ctx"])
    pf_kw = dict(block_q=pf["block_q"], group=pf["group"], scale=scale)
    return {
        "paged_decode": (
            lambda: K.paged_decode(qg, kt, vt, pt, ctx, cells_per_kv=1,
                                   scale=scale),
            lambda: K.paged_decode_plain(qg, kt, vt, pt, ctx, cells_per_kv=1,
                                         scale=scale)),
        "paged_decode[baseline]": (
            lambda: K.paged_decode(qb, kt, vt, pt, ctx, cells_per_kv=group,
                                   scale=scale),
            lambda: K.paged_decode_plain(qb, kt, vt, pt, ctx,
                                         cells_per_kv=group, scale=scale)),
        "paged_decode_segmented": (
            lambda: K.paged_decode_segmented(qg, kt, vt, pt, ctx, **seg_kw),
            lambda: K.paged_decode_segmented_plain(qg, kt, vt, pt, ctx,
                                                   **seg_kw)),
        "segment_reduce": (
            lambda: K.segment_reduce(*parts, dtype),
            lambda: K.segment_reduce_plain(*parts, dtype)),
        "paged_prefill_qblock": (
            lambda: K.paged_prefill_qblock(*pf_args, **pf_kw),
            lambda: K.paged_prefill_qblock_plain(*pf_args, **pf_kw)),
    }, dict(q=q, kp=kp, vp=vp, pt=pt, ctx=ctx, nseg=nseg, tps=tps, pf=pf,
            parts=parts, tile=tile, ps=ps)


def max_err(torch, name, got, want):
    """Max abs error; the segmented partials are compared as acc / l
    (the unnormalised accumulator grows with the context) plus m, l."""
    if name == "paged_decode_segmented":
        (o, m, l), (o2, m2, l2) = got, want
        norm = lambda a, b: a / torch.where(b == 0, 1.0, b)[..., None]  # noqa: E731
        errs = [(norm(o, l) - norm(o2, l2)).abs().max(),
                (m - m2).abs().max(),
                ((l - l2).abs() / l2.clamp_min(1.0)).max()]
        return max(float(e) for e in errs)
    return float((got.float() - want.float()).abs().max())


def phase_check(torch, K, tops):
    errs: dict[str, float] = {}
    for dtype_name, ps in (("float32", 16), ("bfloat16", 16),
                           ("float32", 24), ("bfloat16", 24)):
        dtype = getattr(torch, dtype_name)
        tile = tops.default_tile(ps)
        calls, _ = kernel_calls(torch, K, dtype, ps, tile, tops)
        for name, (kfn, pfn) in calls.items():
            got = kfn()
            want = pfn()
            torch.cuda.synchronize()
            err = max_err(torch, name, got, want)
            ok = err <= ATOL[dtype_name]
            log(f"check {name:24s} {dtype_name:8s} page {ps:2d} tile {tile:2d}"
                f"  max_abs_err {err:.3e}  atol {ATOL[dtype_name]:g}"
                f"  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({dtype_name}, page {ps})")
            base = name.split("[")[0]
            errs[base] = max(errs.get(base, 0.0), err)
        # exact zeros for the dead decode row (context 0)
        out = calls["paged_decode"][0]()
        if not bool((out[0] == 0).all()):
            raise AssertionError("context-0 decode row is not exact zeros")
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters, flush):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()  # evict the 50 MB L2: the step finds KV cold
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bounds(name, x, dtype_name):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and FLOPs /
    peak, counting each input read once, each output written once, and
    only the K/V this run's contexts need."""
    e = 2 if dtype_name == "bfloat16" else 4
    q, pt, ctx, tile = x["q"], x["pt"], x["ctx"], x["tile"]
    s, hq, d = q.shape
    hkv = x["kp"].shape[0]
    ctx_l = [int(c) for c in ctx.tolist()]
    live_kv = sum(-(-c // tile) * tile for c in ctx_l)
    meta = pt.numel() * 4 + ctx.numel() * 4
    nseg = x["nseg"]
    m = hq // hkv
    seg_out = s * hkv * nseg * (m * d + 2 * m) * 4
    if name == "paged_decode":
        nbytes = 2 * q.numel() * e + 2 * live_kv * hkv * d * e + meta
        flops = 4 * hq * d * sum(ctx_l)
    elif name == "paged_decode_segmented":
        nbytes = q.numel() * e + 2 * live_kv * hkv * d * e + meta + seg_out
        flops = 4 * hq * d * sum(ctx_l)
    elif name == "segment_reduce":
        nbytes = seg_out + q.numel() * e
        flops = 3 * s * hkv * nseg * m * d
    else:  # paged_prefill_qblock
        pf = x["pf"]
        pctx = [int(c) for c in pf["ctx"].tolist()]
        live = sum(-(-c // tile) * tile for c in pctx)
        nbytes = (2 * pf["q_packed"].numel() * e + 2 * live * hkv * d * e
                  + pf["pt"].numel() * 4 + 2 * pf["qb_seq"].numel() * 4)
        keys = 0  # causal keys per live query row
        for c, ql in zip(pctx, pf["qlens"]):
            start = c - ql
            keys += sum(start + i + 1 for i in range(ql))
        flops = 4 * hq * d * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_calls(torch, x):
    """One PyTorch yardstick per kernel where one computes the same
    function: a page gather + scaled_dot_product_attention (timed only,
    never used by the port)."""
    F = torch.nn.functional
    q, kp, vp, pt, ctx = x["q"], x["kp"], x["vp"], x["pt"], x["ctx"]
    s, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    group = hq // hkv
    length = pt.shape[1] * ps
    pos = torch.arange(length, device=q.device)
    dmask = (pos[None, :] < ctx[:, None].long())[:, None, None, :]
    pt_l = pt.long()

    def decode():
        k = kp[:, pt_l].reshape(hkv, s, length, d).transpose(0, 1)
        v = vp[:, pt_l].reshape(hkv, s, length, d).transpose(0, 1)
        k = k.repeat_interleave(group, 1)
        v = v.repeat_interleave(group, 1)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=dmask)

    pf = x["pf"]
    qp, qb_seq, qb_pos0 = pf["q_packed"], pf["qb_seq"], pf["qb_pos0"]
    nqb, _, bm, _ = qp.shape
    seq_c = qb_seq.clamp_min(0).long()
    ppt = pf["pt"].long()[seq_c]  # [NQB, Np]
    pctx = pf["ctx"].long()[seq_c]
    q_pos = qb_pos0.long()[:, None] + torch.arange(bm, device=q.device) \
        // pf["group"]
    pmask = ((pos[None, None, :] < pctx[:, None, None])
             & (pos[None, None, :] <= q_pos[:, :, None]))[:, None]

    def prefill():
        k = pf["k"][:, ppt].reshape(hkv, nqb, length, d).transpose(0, 1)
        v = pf["v"][:, ppt].reshape(hkv, nqb, length, d).transpose(0, 1)
        return F.scaled_dot_product_attention(qp, k, v, attn_mask=pmask)

    return {"paged_decode": decode, "paged_prefill_qblock": prefill}


def phase_time(torch, K, tops, dtype_name="bfloat16", iters=20):
    dtype = getattr(torch, dtype_name)
    ps = 16
    tile = tops.default_tile(ps)
    calls, x = kernel_calls(torch, K, dtype, ps, tile, tops)
    lib = library_calls(torch, x)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name in REPLACES:
        kfn, pfn = calls[name]
        ms = time_ms(torch, kfn, iters, flush)
        plain_ms = time_ms(torch, pfn, 3, flush)
        lib_ms = time_ms(torch, lib[name], iters, flush) if name in lib \
            else None
        bound_ms, bound_by = bounds(name, x, dtype_name)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"time  {name:24s} {dtype_name} kernel_ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}  bound_ms "
            f"{bound_ms:.5f} ({bound_by})")
    return rows


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def phase_serve(torch, K):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[ARCH]
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    log(f"serve {ARCH}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_q_heads}/{cfg.num_kv_heads} vocab {cfg.vocab_size}"
        f" {cfg.dtype}; weights in {time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=8, num_pages=2048, max_model_len=2048,
                  enable_chunked_prefill=True, max_prefill_tokens=512,
                  seed=SEED, debug_logits=True, device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def prompts(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
        return [torch.randint(1, cfg.vocab_size, (n_,), generator=g).tolist()
                for n_ in lens]

    # warm-up (cuBLAS handles, allocator) on a throwaway engine
    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in prompts(2, 40, 200)])
    del warm
    torch.cuda.synchronize()

    eng = Engine(cfg, model, **eng_kw)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts(8, 128, 1024)]
    for r in reqs:
        eng.add_request(r)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.sched.has_work and steps < 1000:
        eng.step()
        steps += 1
        if not bool(torch.isfinite(eng.last_step_logits).all()):
            raise AssertionError(f"non-finite logits at step {steps}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if not all(r.state is State.FINISHED and len(r.output) == 32
               for r in reqs):
        raise AssertionError("not every request finished")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if {v for _, v in eng.dispatch_counts} != {"gqa", "segmented"}:
        raise AssertionError("expected mixed steps on gqa and decode-heavy "
                             f"steps on segmented: {eng.dispatch_counts}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"serve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}")
    log(f"serve dispatch_counts {dict(eng.dispatch_counts)}")
    log(f"serve launches {launches}  launched_token_slots "
        f"{eng.launched_token_slots}")
    return launches, dict(steps=steps, wall_s=wall, new_tokens=toks,
                          prompt_tokens=prompt_toks)


def phase_diff(torch):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    cfg = ARCHS[ARCH].replace(dtype="float32")
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256, seed=SEED,
                  debug_logits=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    lens = [37, 70, 101]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    engines, reqs = [], []
    for dev in (DEVICE, "cpu"):
        eng = Engine(cfg, weights.init_random(cfg, SEED, device=dev),
                     device=dev, **eng_kw)
        rs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        for r in rs:
            eng.add_request(r)
        engines.append(eng)
        reqs.append(rs)
    worst = 0.0
    steps = 0
    while engines[0].sched.has_work:
        stats = [e.step() for e in engines]
        steps += 1
        if stats[0]["sampled_tokens"] != stats[1]["sampled_tokens"]:
            raise AssertionError(f"step {steps}: engines diverged")
        a = engines[0].last_step_logits.cpu()
        worst = max(worst, float((a - engines[1].last_step_logits).abs()
                                 .max()))
    gpu_out = [r.output for r in reqs[0]]
    cpu_out = [r.output for r in reqs[1]]
    log(f"diff fp32 {len(prompts)} requests x 8 greedy tokens, {steps} "
        f"steps: max_abs_logit_diff {worst:.3e} (bound {DIFF_LOGIT_ATOL:g})"
        f"  tokens_identical {gpu_out == cpu_out}")
    if gpu_out != cpu_out:
        raise AssertionError(f"greedy tokens differ:\n cuda {gpu_out}\n "
                             f"cpu  {cpu_out}")
    if engines[1].sched.has_work:
        raise AssertionError("cpu engine did not finish in lockstep")
    if not worst <= DIFF_LOGIT_ATOL:
        raise AssertionError(f"logit difference {worst} > {DIFF_LOGIT_ATOL}")
    return worst


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "paged_attention.cu").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device {kind}  count {torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi {smi}")

    # 2. build
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as tops

    t0 = time.perf_counter()
    K.library()
    log(f"build paged_attention.cu -> {_build.library_path('paged_attention')}"
        f" in {time.perf_counter() - t0:.1f}s (nvcc "
        f"{_build.BUILD_SECONDS.get('paged_attention', 0.0):.1f}s)")

    # 3. kernels against their plain versions
    errs = phase_check(torch, K, tops)

    # 4. kernel times at the main path's shapes (bf16, the serving dtype)
    times = phase_time(torch, K, tops)

    # 5. end to end through the port's main path
    launches, serve = phase_serve(torch, K)

    # 6. card (kernels) vs CPU (plain versions), fp32
    phase_diff(torch)

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], **times[name])
               for name in REPLACES]
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
