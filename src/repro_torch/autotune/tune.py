"""Autotuning-results -> decision-tree export (paper §5.2, Fig. 5 right
half; Listing 2): a copy of `repro.autotune.tune` over the port's
microbenchmark, Hopper cost model and heuristics.

The tree is fit by greedy regret minimization: at each node try every
(feature, threshold) split and keep the one that most reduces total latency
regret vs the per-scenario oracle; leaves emit the regret-minimizing
KernelConfig. Exported as (a) the heuristics JSON consumed by
`repro_torch.core.attention.heuristics.load`, and (b) a Listing-2-style
Python snippet for human review.
"""
from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.autotune.costmodel import (
    Scenario, split_phases, suggest_max_prefill_tokens,
)
from repro_torch.autotune.microbench import (
    ARCH_DEFAULTS, DECODE_SPACE, ITERS, PREFILL_SPACE, UNIFIED_SPACE, WARMUP,
    SweepResult, measure, scenario_grid, sweep,
)
from repro_torch.core.attention.heuristics import KernelConfig
from repro_torch.roofline import hw

FEATURES = ("num_seqs", "max_context", "group", "decode_share",
            "avg_query_len", "total_tokens", "spec_tokens")


def _feat(sr: SweepResult, name: str):
    return getattr(sr.scenario, name)


def _best_single(results: list[SweepResult], space) -> tuple[int, float]:
    """(config idx, total regret) of the best single config for a subset."""
    best_idx, best_cost = 0, float("inf")
    for i in range(len(space)):
        cost = sum(sr.timings[i] for sr in results)
        if cost < best_cost:
            best_idx, best_cost = i, cost
    oracle = sum(min(sr.timings.values()) for sr in results)
    return best_idx, best_cost - oracle


@dataclasses.dataclass
class Node:
    config_idx: int | None = None
    feature: str | None = None
    threshold: float | None = None
    le: "Node | None" = None
    gt: "Node | None" = None


def fit_tree(results: list[SweepResult], space, *, max_depth: int = 3,
             min_leaf: int = 3) -> Node:
    idx, regret = _best_single(results, space)
    if max_depth == 0 or regret <= 0 or len(results) < 2 * min_leaf:
        return Node(config_idx=idx)
    best = None  # (regret_sum, feature, threshold, lo, hi)
    for feat in FEATURES:
        values = sorted({_feat(r, feat) for r in results})
        for thr in values[:-1]:
            lo = [r for r in results if _feat(r, feat) <= thr]
            hi = [r for r in results if _feat(r, feat) > thr]
            if len(lo) < min_leaf or len(hi) < min_leaf:
                continue
            _, rl = _best_single(lo, space)
            _, rh = _best_single(hi, space)
            if best is None or rl + rh < best[0]:
                best = (rl + rh, feat, thr, lo, hi)
    if best is None or best[0] >= regret:
        return Node(config_idx=idx)
    _, feat, thr, lo, hi = best
    return Node(
        feature=feat, threshold=thr,
        le=fit_tree(lo, space, max_depth=max_depth - 1, min_leaf=min_leaf),
        gt=fit_tree(hi, space, max_depth=max_depth - 1, min_leaf=min_leaf),
    )


def flatten(node: Node, space, cond=None) -> list[tuple[dict, dict]]:
    """Tree -> first-match (condition, config) list for heuristics.load."""
    cond = cond or {}
    if node.config_idx is not None:
        cfg = space[node.config_idx]
        return [(cond, {
            "variant": cfg.variant, "tile": cfg.tile,
            "num_segments": cfg.num_segments, "block_q": cfg.block_q,
        })]
    out = flatten(node.le, space,
                  {**cond, f"{node.feature}_le": node.threshold})
    out += flatten(node.gt, space,
                   {**cond, f"{node.feature}_ge": node.threshold + 1e-9})
    return out


def to_listing(node: Node, space, indent=0) -> str:
    """Human-readable Listing-2-style rendering."""
    pad = "    " * indent
    if node.config_idx is not None:
        c = space[node.config_idx]
        return (f"{pad}return KernelConfig({c.variant!r}, tile={c.tile},"
                f" num_segments={c.num_segments}, block_q={c.block_q})\n")
    s = f"{pad}if {node.feature} <= {node.threshold}:\n"
    s += to_listing(node.le, space, indent + 1)
    s += f"{pad}else:\n"
    s += to_listing(node.gt, space, indent + 1)
    return s


def regret_report(results, space, tree: Node) -> dict:
    """Tuned-vs-untuned summary (the paper's Fig. 8 quantities)."""
    def tree_cfg_idx(sr):
        node = tree
        while node.config_idx is None:
            node = node.le if _feat(sr, node.feature) <= node.threshold \
                else node.gt
        return node.config_idx

    oracle = sum(min(sr.timings.values()) for sr in results)
    tuned = sum(sr.timings[tree_cfg_idx(sr)] for sr in results)
    default_idx, _ = _best_single(results, space)
    untuned = sum(sr.timings[default_idx] for sr in results)
    worst_speedup = max(
        sr.timings[default_idx] / sr.timings[tree_cfg_idx(sr)]
        for sr in results
    )
    return {
        "oracle_s": oracle, "tuned_s": tuned, "untuned_best_fixed_s": untuned,
        "tuned_vs_untuned_speedup": untuned / tuned,
        "tuned_vs_oracle_overhead": tuned / oracle - 1.0,
        "max_pointwise_speedup": worst_speedup,
    }


_PHASE_SPACES = {"decode": DECODE_SPACE, "prefill": PREFILL_SPACE,
                 "unified": UNIFIED_SPACE}


def scenario_from_profile(profile: dict, arch: dict,
                          phase: str) -> Scenario:
    """Synthesize a cost-model `Scenario` that reproduces a production
    `BatchProfile`'s feature vector (the telemetry latency grid's keys).

    The engine buckets profiles before dispatch, so an exact
    reconstruction is impossible and unnecessary: the tree only splits on
    FEATURES, and those are derived properties this scenario reproduces —
    `num_seqs`, `max_context`, `group` (via synthesized head counts),
    `decode_share`, `avg_query_len`, `total_tokens` (approximately, from
    the bucketed values).  Prefill rows are clamped to q >= 2: a q == 1
    row would be misclassified as decode by `split_phases`."""
    kv = int(arch.get("num_kv_heads", ARCH_DEFAULTS["num_kv_heads"]))
    n = max(int(profile["num_seqs"]), 1)
    ctx = max(int(profile["max_context"]), 1)
    if phase == "decode":
        qlens = (1,) * n
    elif phase == "prefill":
        q = min(max(int(profile["avg_query_len"]), 2), ctx)
        qlens = (q,) * n
    else:  # unified: reproduce the packed decode/prefill mix
        n_dec = min(int(round(n * float(profile["decode_share"]))), n)
        n_pre = n - n_dec
        if n_pre:
            q = (int(profile["total_tokens"]) - n_dec) // n_pre
            qlens = (1,) * n_dec + (min(max(q, 2), ctx),) * n_pre
        else:
            qlens = (1,) * n
    return Scenario(
        num_seqs=n, context_lens=(ctx,) * n, query_lens=qlens,
        num_q_heads=max(int(profile["group"]), 1) * kv, num_kv_heads=kv,
        head_dim=int(arch.get("head_dim", ARCH_DEFAULTS["head_dim"])),
        page_size=int(profile["page_size"])
        or int(arch.get("page_size", ARCH_DEFAULTS["page_size"])),
        spec_tokens=int(profile.get("spec_tokens", 0) or 0),
    )


def _cfg_key(cfg: KernelConfig) -> tuple:
    return (cfg.variant, cfg.tile, cfg.num_segments, cfg.block_q)


def _median(xs: list[float]) -> float | None:
    return sorted(xs)[len(xs) // 2] if xs else None


def refit_from_telemetry(grid, path_json: str | None = None,
                         path_listing: str | None = None, *,
                         min_count: int = 1, max_depth: int = 3,
                         min_leaf: int = 2,
                         separate_host_overhead: bool = False) -> dict:
    """Refit the heuristics trees from a serving-telemetry latency grid
    (`obs.Telemetry.latency_grid()` / `export_latency_grid`), closing the
    telemetry→autotune loop: production launches replace the offline
    sweep as the measurement source.

    Production only observes the config the CURRENT tree dispatched per
    profile, so a naive refit would have nothing to compare against.  The
    gap is filled with the analytic cost model, CALIBRATED to the
    observations: unobserved configs get `predicted * ratio`, where
    `ratio` is the per-phase median of observed/predicted over the
    (profile, config) pairs that WERE observed — absolute scale comes
    from production, relative config ranking from the model.  Observed
    configs outside the base search space are appended to it, so a
    hand-rolled or previously-refit config stays representable.

    Grid entries recorded by a telemetry-enabled engine also carry the
    executable's analytic cost (`flops` / `bytes_accessed`,
    `Engine._exe_cost`).  The
    roofline terms over those give a device-time floor per observation;
    `observed - floor` estimates the HOST overhead riding on every
    launch (dispatch, donation bookkeeping, the timing barrier).  The
    per-phase median of that estimate is always reported
    (`host_overhead_s_est`, `device_time_fraction`); with
    `separate_host_overhead=True` it is additionally folded into the
    calibration — ratios are fit on `observed - host_overhead` and
    unobserved configs get `predicted * ratio + host_overhead` — so the
    model calibrates against device time instead of absorbing a constant
    host cost into a multiplicative ratio.

    `grid` is the dict or a path to its JSON.  Entries with fewer than
    `min_count` warm launches are dropped (single launches are noisy).
    Returns a report; writes a `heuristics.load`-compatible JSON to
    `path_json` (the `decode_tree` key is always present, as `load`
    requires) and a Listing-2-style rendering to `path_listing`."""
    if isinstance(grid, str):
        with open(grid) as f:
            grid = json.load(f)
    arch = dict(ARCH_DEFAULTS)
    arch.update(grid.get("arch") or {})

    # phase -> profile(frozen) -> {config key: observed mean seconds}
    by_phase: dict[str, dict[tuple, dict[tuple, float]]] = {}
    # phase -> [(observed mean, roofline device-time floor)] where the
    # entry carried cost numbers
    dev_points: dict[str, list[tuple[float, float]]] = {}
    for e in grid.get("entries", ()):
        if e["count"] < min_count or e["phase"] not in _PHASE_SPACES:
            continue
        prof = tuple(sorted(e["profile"].items()))
        c = e["config"]
        key = (c["variant"], c.get("tile"), c.get("num_segments", 8),
               c.get("block_q", 16))
        by_phase.setdefault(e["phase"], {}).setdefault(prof, {})[key] = \
            e["mean_s"]
        flops = e.get("flops") or 0.0
        nbytes = e.get("bytes_accessed") or 0.0
        if flops or nbytes:
            dev = max(flops / hw.PEAK_FLOPS_BF16, nbytes / hw.HBM_BW)
            dev_points.setdefault(e["phase"], []).append((e["mean_s"], dev))

    payload: dict = {"decode_tree": []}
    report: dict = {"phases": {}}
    listings: list[tuple[str, str]] = []
    for phase, profiles in sorted(by_phase.items()):
        space = list(_PHASE_SPACES[phase])
        known = {_cfg_key(c) for c in space}
        for cfgs in profiles.values():
            for key in cfgs:
                if key not in known:
                    known.add(key)
                    space.append(KernelConfig(
                        key[0], tile=key[1], num_segments=key[2],
                        block_q=key[3]))
        # device-vs-host split (diagnostic always; applied on request)
        points = dev_points.get(phase, ())
        host_est = _median([max(m - dv, 0.0) for m, dv in points])
        dev_frac = _median([min(dv / m, 1.0) for m, dv in points if m > 0])
        host = host_est if separate_host_overhead and host_est else 0.0
        # pass 1: predict every config per profile; collect calibration
        # ratios where the dispatched config was actually observed.  With
        # host separation the ratio is fit on the device-side residual
        # (floored at 1% of observed so a host-dominated grid can't
        # collapse the ratio to zero).
        rows, ratios = [], []
        for prof, cfgs in profiles.items():
            sc = scenario_from_profile(dict(prof), arch, phase)
            pred = {i: measure(sc, c, unified=(phase == "unified"))
                    for i, c in enumerate(space)}
            rows.append((sc, cfgs, pred))
            for i, c in enumerate(space):
                p = pred[i]
                if _cfg_key(c) in cfgs and math.isfinite(p) and p > 0:
                    obs = cfgs[_cfg_key(c)]
                    ratios.append(max(obs - host, 0.01 * obs) / p)
        ratio = sorted(ratios)[len(ratios) // 2] if ratios else 1.0
        # pass 2: observed where we have it, calibrated model elsewhere
        results = [SweepResult(sc, {
            i: cfgs.get(_cfg_key(c), pred[i] * ratio + host)
            for i, c in enumerate(space)})
            for sc, cfgs, pred in rows]
        tree = fit_tree(results, space, max_depth=max_depth,
                        min_leaf=min_leaf)
        payload[f"{phase}_tree"] = flatten(tree, space)
        stats = regret_report(results, space, tree)
        stats.update(profiles=len(results), space_size=len(space),
                     observed_points=sum(len(c) for c in
                                         profiles.values()),
                     calibration_ratio=ratio,
                     host_overhead_s_est=host_est,
                     device_time_fraction=dev_frac,
                     host_overhead_applied_s=host)
        report["phases"][phase] = stats
        listings.append((phase, to_listing(tree, space)))

    if path_json:
        with open(path_json, "w") as f:
            json.dump(payload, f, indent=1)
    if path_listing:
        with open(path_listing, "w") as f:
            f.write("# decision trees refit from serving telemetry\n")
            for phase, listing in listings:
                f.write(f"# --- {phase} ---\n")
                f.write(listing)
    report["payload"] = payload
    return report


def tune_and_export(path_json: str, path_listing: str | None = None, *,
                    use_hardware: bool = False, seed: int = 0,
                    max_seqs: int = 8, target_context: int = 2048,
                    grid: list[Scenario] | None = None,
                    warmup: int = WARMUP, iters: int = ITERS,
                    **arch_kw) -> dict:
    """Full Fig.-5 workflow: sweep the scenario grid, fit one decision tree
    PER PHASE, and export them with the roofline chunk-size suggestion.

    Each grid scenario is split into its decode (q == 1) and prefill
    (q > 1) sub-batches — in the PADDED engine the two phases are separate
    launches with separate tuning surfaces, so the decode tree is fit on
    decode sub-batches over DECODE_SPACE and the prefill tree on prefill
    sub-batches over PREFILL_SPACE.  The mixed-share grid rows thereby
    contribute to BOTH trees instead of being filtered out.

    The PACKED engine's single launch is tuned separately: the unified
    tree is fit on the UNSPLIT mixed-batch grid rows over UNIFIED_SPACE
    (decode variant x chunk Q-block per config), with the packed-mix
    features (`total_tokens`, `decode_share`) available as split
    dimensions — the packed launch profile is a first-class point in the
    tuning space, not a sum of per-phase optima.

    `grid` replaces the reference's `scenario_grid(seed=seed, **arch_kw)`
    (a cut grid of the same recipe); `warmup` / `iters` are the card
    timing's (`use_hardware`).  The report also carries each phase's
    `results` (the `SweepResult`s)."""
    if grid is None:
        grid = scenario_grid(seed=seed, **arch_kw)
    timing = dict(use_hardware=use_hardware, warmup=warmup, iters=iters)
    phases = [split_phases(s) for s in grid]
    dec_scenarios = [d for d, _ in phases if d is not None]
    pre_scenarios = [p for _, p in phases if p is not None]

    dec_results = sweep(dec_scenarios, DECODE_SPACE, **timing)
    pre_results = sweep(pre_scenarios, PREFILL_SPACE, **timing)
    uni_results = sweep(grid, UNIFIED_SPACE, unified=True, **timing)
    dec_tree = fit_tree(dec_results, DECODE_SPACE)
    pre_tree = fit_tree(pre_results, PREFILL_SPACE)
    uni_tree = fit_tree(uni_results, UNIFIED_SPACE)

    arch = dict(ARCH_DEFAULTS)
    arch.update({k: v for k, v in arch_kw.items() if k in arch})
    chunk = suggest_max_prefill_tokens(
        max_seqs=max_seqs, target_context=target_context, **arch)
    payload = {
        "decode_tree": flatten(dec_tree, DECODE_SPACE),
        "prefill_tree": flatten(pre_tree, PREFILL_SPACE),
        "unified_tree": flatten(uni_tree, UNIFIED_SPACE),
        "suggested_max_prefill_tokens": chunk,
    }
    with open(path_json, "w") as f:
        json.dump(payload, f, indent=1)
    listing = to_listing(dec_tree, DECODE_SPACE)
    pre_listing = to_listing(pre_tree, PREFILL_SPACE)
    uni_listing = to_listing(uni_tree, UNIFIED_SPACE)
    if path_listing:
        with open(path_listing, "w") as f:
            f.write("# auto-generated decision trees "
                    "(paper Listing 2 analog)\n")
            f.write("# --- decode ---\n")
            f.write(listing)
            f.write("# --- prefill ---\n")
            f.write(pre_listing)
            f.write("# --- unified (token-packed step) ---\n")
            f.write(uni_listing)
            f.write(f"# max_prefill_tokens = {chunk}  "
                    "(decode-latency roofline)\n")
    report = regret_report(dec_results, DECODE_SPACE, dec_tree)
    report["listing"] = listing
    report["prefill"] = regret_report(pre_results, PREFILL_SPACE, pre_tree)
    report["prefill"]["listing"] = pre_listing
    report["unified"] = regret_report(uni_results, UNIFIED_SPACE, uni_tree)
    report["unified"]["listing"] = uni_listing
    report["suggested_max_prefill_tokens"] = chunk
    report["results"] = {"decode": dec_results, "prefill": pre_results,
                         "unified": uni_results}
    return report
