"""The audio and vlm families (musicgen-large: rope "none", 32 / 32 heads;
qwen2-vl-2b: M-RoPE, q / k / v biases, group 6 at full size) against the
JAX reference on the CPU, on their `reduced` forms in fp32 with the
weights of `M.init(cfg, key(0))`:

  * `apply_mrope` against the reference's on a Qwen2-VL patch grid (t
    constant over an image's patches, h / w its row and column, text
    after it at t = h = w: distinct rows, so a wrong section map shows),
    1e-6;
  * the attention layer in modes train, prefill, prefill_cached, decode
    and unified against `attention.attention`, 1e-5;
  * `apply_prefill` on [B, S, d] embedding inputs, `apply_prefill_cached`
    on a resumed chunk of embeddings, `apply_decode` and `apply_unified`
    on token ids: logits at 1e-4, pages at 1e-5;
  * `apply_train` with embedding inputs and patch-grid positions: the loss
    at 1e-5 relative, every gradient at 1e-4 of its largest element (the
    embedding table's is zero on both sides: the loss does not reach it);
    `train_step` over 2 microbatches against one batch (1e-6);
  * the packed `Engine` token for token against the JAX engine (outputs,
    steps, `launched_token_slots`, `compile_events` by repr, no page
    leaked) on a mixed trace for both models, and on a chunked, a
    speculative and a preempting trace for qwen2-vl;
  * `MLAAttention` at `rope_style="none"` on reduced deepseek-v2 against
    `_mla_attention` (prefill then decode).

The serving modes address the KV pages by the positions' temporal row (the
reference's `positions[0]`).  A true image grid, whose patches share one
t, would write them all to one slot, in the reference and in the port
alike; the engines of both serve token ids (t = h = w).  So the serving
tests feed grids whose temporal row is the in-sequence index, with h and
w the patches' row and column: distinct rows, distinct slots.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.paged.kv_cache import physical_slots, write_index
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.attention import Attention, MLAAttention, temporal
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request as TRequest, State
from repro_torch.training.trainer import make_train_state, train_step

import serving_harness as H

MUSICGEN, QWEN2VL = "musicgen-large", "qwen2-vl-2b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE = dict(max_seqs=4, num_pages=64, max_model_len=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models are tiny: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(arch):
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    params = jax.jit(lambda key: JM.init(jcfg, key))(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    return jcfg, tcfg, params, params_np, model


@pytest.fixture(scope="module")
def built():
    """Each family's (jcfg, tcfg, params, params_np, model), built once."""
    return functools.cache(_build)


@pytest.fixture(scope="module", params=[MUSICGEN, QWEN2VL])
def fam(request, built):
    return built(request.param)


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def patch_grid(b, s, *, seed, index_t=False):
    """[3, B, S] int32 Qwen2-VL positions: each row 1-3 text tokens (t = h
    = w = index), one image of hh x ww patches (t the image's start, h =
    start + patch row, w = start + patch column), then text again from
    start + max(hh, ww).  `index_t`: t is the token's index instead (the
    serving grids: one KV slot a token), h / w as before."""
    rng = np.random.default_rng(seed)
    n = max(s, 32)
    pos = np.zeros((3, b, n), np.int32)
    for i in range(b):
        pre = int(rng.integers(1, 4))
        hh, ww = int(rng.integers(2, 4)), int(rng.integers(2, 5))
        pos[:, i, :pre] = np.arange(pre)
        r, c = np.divmod(np.arange(hh * ww), ww)
        img = slice(pre, pre + hh * ww)
        pos[0, i, img] = pre
        pos[1, i, img] = pre + r
        pos[2, i, img] = pre + c
        rest = n - (pre + hh * ww)
        pos[:, i, pre + hh * ww:] = pre + max(hh, ww) + np.arange(rest)
        if index_t:
            pos[0, i] = np.arange(n)
    return pos[:, :, :s]


def _positions(cfg, pos_2d, *, seed):
    """A serving batch's positions for `cfg`: [B, S] as given, or for
    "mrope" t = the given positions and h / w offset from t as a patch
    grid's are, from inside an image on (distinct rows from the first
    token)."""
    if cfg.rope_style != "mrope":
        return pos_2d.astype(np.int32)
    b, s = pos_2d.shape
    grid = patch_grid(b, s + 4, seed=seed, index_t=True)
    delta = grid - np.arange(s + 4, dtype=np.int32)
    pos = (pos_2d[None] + delta[:, :, 4:]).astype(np.int32)
    assert (pos[1:, :, 0] != pos[0, :, 0]).any()
    return pos


# ---------------------------------------------------------------------------
# M-RoPE and the attention layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,d", [((16, 24, 24), 128), ((8, 12, 12), 64)])
def test_apply_mrope_matches_reference(sections, d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 3, d)).astype(np.float32)
    pos = patch_grid(2, 40, seed=1) * 37  # large angles too
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # equal rows are plain RoPE; the grid is not
    same = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos[:1]).expand(
        3, -1, -1), 1e6, sections)
    np.testing.assert_allclose(
        same.numpy(), TL.apply_rope(torch.from_numpy(x),
                                    torch.from_numpy(pos[0]), 1e6).numpy(),
        atol=1e-6)
    assert not np.allclose(same.numpy(), got.numpy(), atol=1e-3)
    with pytest.raises(AssertionError):
        TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       (8, 8, 8))


def _layer(jcfg, tcfg, seed=3):
    """(reference attention params, the port's Attention holding them)."""
    p = JATT.init_attention(jcfg, jax.random.key(seed))
    p_np = jax.tree.map(np.asarray, p)
    attn = Attention(tcfg)
    with torch.no_grad():
        for path, t in weights._attn_leaves(attn):
            src = p_np
            for key in path:
                src = src[key]
            t.copy_(torch.from_numpy(np.array(src)))
    assert {path[0] for path, _ in weights._attn_leaves(attn)} == set(p_np)
    return p, attn


def test_attention_layer_matches_reference(fam):
    """One layer through train (a true patch grid), prefill of 2 rows (24
    and 13 of 24 valid), a resumed chunk of 8, a decode token each (the
    second slot dead), and a packed unified step of one decode row and
    one chunk: output and pages at 1e-5."""
    jcfg, tcfg = fam[0], fam[1]
    p, attn = _layer(jcfg, tcfg)
    rng = np.random.default_rng(5)
    d, ps, hkv, dh = jcfg.d_model, jcfg.page_size, jcfg.num_kv_heads, \
        jcfg.resolved_head_dim
    b, s, np_ = 2, 24, 3
    num_pages = b * np_ + 1
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    pages = {n: np.zeros((hkv, 1, num_pages, ps, dh), np.float32)
             for n in ("k_pages", "v_pages")}
    jpages = {n: jnp.asarray(v) for n, v in pages.items()}
    tpages = {n: torch.from_numpy(v.copy()) for n, v in pages.items()}

    def run(mode, x, pos, meta_np, valid=None):
        jmeta, tmeta = _both(meta_np)
        tpos = torch.from_numpy(pos)
        if mode == "unified":
            tmeta["write_index"] = write_index(
                tmeta["slot_mapping"], num_pages * ps)
            tmeta["num_decode_seqs"] = jmeta["num_decode_seqs"] = 1
        elif valid is not None:
            slots = physical_slots(tmeta["page_table"], temporal(tpos),
                                   torch.from_numpy(valid), ps, num_pages)
            tmeta["write_index"] = write_index(slots.reshape(1, -1),
                                               num_pages * ps)
        nds = jmeta.pop("num_decode_seqs", None)
        want, jc = jax.jit(lambda p_, x_, pos_, c_, m_: JATT.attention(
            jcfg, p_, x_, pos_, mode=mode, cache=c_,
            meta=m_ if nds is None else dict(m_, num_decode_seqs=nds)))(
            p, jnp.asarray(x), jnp.asarray(pos),
            None if mode == "train" else dict(jpages), jmeta)
        fwd = {"train": None, "unified": attn,
               "prefill": attn.forward_prefill,
               "prefill_cached": attn.forward_prefill,
               "decode": attn.forward_decode}[mode]
        with torch.no_grad():
            if mode == "train":
                got = attn.forward_train(torch.from_numpy(x), tpos)
            else:
                got = fwd(torch.from_numpy(x), tpos, tpages["k_pages"],
                          tpages["v_pages"], tmeta)
        rows = (slice(None) if valid is None or mode == "decode"
                else valid)  # a padded prefill row's output is not read
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   err_msg=mode, **LAYER_TOL)
        if jc is not None:
            for n in jpages:
                jpages[n] = jc[n]
                np.testing.assert_allclose(tpages[n].numpy(),
                                           np.asarray(jc[n]), err_msg=mode,
                                           **LAYER_TOL)

    x = rng.standard_normal((b, s, d)).astype(np.float32)
    grid = (patch_grid(b, s, seed=2) if jcfg.rope_style == "mrope"
            else np.tile(np.arange(s, dtype=np.int32), (b, 1)))
    run("train", x, grid, {})
    qlens = np.asarray([24, 13], np.int32)
    pos = _positions(jcfg, np.tile(np.arange(s), (b, 1)), seed=3)
    valid = np.arange(s)[None] < qlens[:, None]
    run("prefill", x, pos, {"page_table": pt, "context_lens": qlens,
                            "query_lens": qlens}, valid)
    c = 8
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    pos = _positions(jcfg, qlens[:, None] + np.arange(c)[None], seed=4)
    run("prefill_cached", x, pos,
        {"page_table": pt, "context_lens": qlens + c,
         "query_lens": np.full((b,), c, np.int32)},
        np.ones((b, c), bool))
    ctx = qlens + c
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    pos = _positions(jcfg, np.asarray([[ctx[0]], [-1]]), seed=5)
    run("decode", x, pos, {"page_table": pt, "context_lens":
                           np.asarray([ctx[0] + 1, 0], np.int32)},
        np.asarray([[True], [False]]))
    # unified: sequence 0 decodes at ctx[0] + 1, sequence 1 a chunk of 5
    t = 1 + 5
    x = rng.standard_normal((1, t, d)).astype(np.float32)
    p2 = np.concatenate([[ctx[0] + 1], ctx[1] + np.arange(5)])[None]
    pos = _positions(jcfg, p2, seed=6)
    seq = np.asarray([0, 1, 1, 1, 1, 1])
    slots = pt[seq, p2[0] // ps] * ps + p2[0] % ps
    run("unified", x, pos, {
        "page_table": pt, "context_lens": np.asarray([ctx[0] + 2,
                                                      ctx[1] + 5], np.int32),
        "query_lens": np.asarray([1, 5], np.int32),
        "query_start_loc": np.asarray([0, 1, 6], np.int32),
        "slot_mapping": slots[None].astype(np.int32)})


def test_mla_attention_rope_none_matches_reference():
    """deepseek-v2's MLA with `rope_style="none"` (the k_rope / q_rope
    columns unrotated): prefill of 2 rows (24 and 13 valid), then one
    decode token each."""
    kw = dict(dtype="float32", rope_style="none")
    jcfg = jreduced(JARCHS["deepseek-v2-236b"]).replace(**kw)
    tcfg = treduced(TARCHS["deepseek-v2-236b"]).replace(**kw)
    p = JATT.init_attention(jcfg, jax.random.key(3))
    p_np = jax.tree.map(np.asarray, p)
    attn = MLAAttention(tcfg)
    with torch.no_grad():
        for path, t in weights._attn_leaves(attn):
            src = p_np
            for key in path:
                src = src[key]
            t.copy_(torch.from_numpy(np.array(src)))
    rng = np.random.default_rng(5)
    b, s, np_, ps = 2, 24, 2, jcfg.page_size
    num_pages = b * np_ + 1
    dk = jcfg.mla.kv_lora_rank + jcfg.mla.qk_rope_dim
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    qlens = np.asarray([24, 13], np.int32)
    jkp = jnp.zeros((1, 1, num_pages, ps, dk), jnp.float32)
    tkp = torch.zeros((1, 1, num_pages, ps, dk))
    for mode, x, pos, meta_np, valid in (
            ("prefill", rng.standard_normal((b, s, jcfg.d_model)),
             np.tile(np.arange(s, dtype=np.int32), (b, 1)),
             {"page_table": pt, "context_lens": qlens, "query_lens": qlens},
             np.arange(s)[None] < qlens[:, None]),
            ("decode", rng.standard_normal((b, 1, jcfg.d_model)),
             qlens[:, None].astype(np.int32),
             {"page_table": pt, "context_lens": qlens + 1},
             np.ones((b, 1), bool))):
        x = x.astype(np.float32)
        jmeta, tmeta = _both(meta_np)
        slots = physical_slots(tmeta["page_table"], torch.from_numpy(pos),
                               torch.from_numpy(valid), ps, num_pages)
        tmeta["write_index"] = write_index(slots.reshape(1, -1),
                                           num_pages * ps)
        want, jc = jax.jit(functools.partial(JATT.attention, jcfg,
                                             mode=mode))(
            p, jnp.asarray(x), jnp.asarray(pos), cache={"k_pages": jkp},
            meta=jmeta)
        fwd = attn.forward_prefill if mode == "prefill" \
            else attn.forward_decode
        with torch.no_grad():
            got = fwd(torch.from_numpy(x), torch.from_numpy(pos), tkp, None,
                      tmeta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=mode, **LAYER_TOL)
        jkp = jc["k_pages"]
        np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp),
                                   err_msg=mode, **LAYER_TOL)


# ---------------------------------------------------------------------------
# the model's serving entry points
# ---------------------------------------------------------------------------


def test_serving_entry_points_match_reference(fam):
    """apply_prefill on embeddings (rows of 24 and 13 valid), a resumed
    chunk of 8 embeddings (apply_prefill_cached), a decode step of ids
    (the second slot dead), then a unified step of one decode row and one
    chunk of 5 ids."""
    jcfg, tcfg, params, _, model = fam
    rng = np.random.default_rng(7)
    b, s, np_, ps = 2, 24, 3, jcfg.page_size
    num_pages = b * np_ + 1
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    jcache = JM.make_cache(jcfg, max_seqs=b, num_pages=num_pages)
    tcache = TM.make_cache(tcfg, max_seqs=b, num_pages=num_pages,
                           device="cpu")

    def check(jl, jc, tl, tc, what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=what,
                                   **LOGIT_TOL)
        for n in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       err_msg=f"{what} {n}", **LAYER_TOL)

    qlens = np.asarray([24, 13], np.int32)
    emb = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    jb, tb = _both({"inputs": emb, "positions": _positions(
        jcfg, np.tile(np.arange(s), (b, 1)), seed=8), "page_table": pt,
        "context_lens": qlens, "query_lens": qlens})
    jl, jcache = jax.jit(functools.partial(JM.apply_prefill, jcfg))(
        params, jcache, jb)
    tl, tcache = TM.apply_prefill(model, tcache, tb)
    check(jl, jcache["attn"], tl, tcache["attn"], "prefill")
    c = 8
    emb = rng.standard_normal((b, c, jcfg.d_model)).astype(np.float32)
    jb, tb = _both({"inputs": emb, "positions": _positions(
        jcfg, qlens[:, None] + np.arange(c)[None], seed=9),
        "page_table": pt, "context_lens": qlens + c,
        "query_lens": np.full((b,), c, np.int32)})
    jl, jcache = jax.jit(functools.partial(JM.apply_prefill_cached, jcfg))(
        params, jcache, jb)
    tl, tcache = TM.apply_prefill_cached(model, tcache, tb)
    check(jl, jcache["attn"], tl, tcache["attn"], "prefill_cached")
    ctx = qlens + c
    ids = rng.integers(1, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
    jb, tb = _both({"inputs": ids, "positions": _positions(
        jcfg, np.asarray([[ctx[0]], [-1]]), seed=10), "page_table": pt,
        "context_lens": np.asarray([ctx[0] + 1, 0], np.int32)})
    jl, jcache = jax.jit(functools.partial(JM.apply_decode, jcfg))(
        params, jcache, jb)
    tl, tcache = TM.apply_decode(model, tcache, tb)
    check(jl[:1], jcache["attn"], tl[:1], tcache["attn"], "decode")
    p2 = np.concatenate([[ctx[0] + 1], ctx[1] + np.arange(5)])[None]
    seq = np.asarray([0, 1, 1, 1, 1, 1])
    ids = rng.integers(1, jcfg.vocab_size, size=(1, 6)).astype(np.int32)
    jb, tb = _both({
        "inputs": ids, "positions": _positions(jcfg, p2, seed=11),
        "page_table": pt,
        "context_lens": np.asarray([ctx[0] + 2, ctx[1] + 5], np.int32),
        "query_lens": np.asarray([1, 5], np.int32),
        "query_start_loc": np.asarray([0, 1, 6], np.int32),
        "slot_mapping": (pt[seq, p2[0] // ps] * ps
                         + p2[0] % ps)[None].astype(np.int32)})
    jl, jnew = jax.jit(functools.partial(JM.apply_unified, jcfg,
                                         num_decode_seqs=1))(
        params, jcache, jb)
    tl, tnew = TM.apply_unified(model, tcache["attn"], tb, num_decode_seqs=1)
    check(jl, jnew["attn"], tl, tnew, "unified")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_apply_train_matches_reference(fam):
    """[B, S, d] embedding inputs (the stub frontend's), labels with
    ignored positions, patch-grid positions for qwen2-vl: the loss and
    every gradient leaf."""
    jcfg, tcfg, params, params_np, _ = fam
    rng = np.random.default_rng(12)
    b, s = 2, 40
    batch = {"inputs": rng.standard_normal((b, s, jcfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(
                 np.int32)}
    batch["labels"][0, :5] = -1
    if jcfg.rope_style == "mrope":
        batch["positions"] = patch_grid(b, s, seed=13)
    vag = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.apply_train(jcfg, p, bt), has_aux=True))
    (want, jm), jgrads = vag(params, _both(batch)[0])
    model = weights.from_jax_params(tcfg, params_np,
                                    device="cpu").requires_grad_(True)
    loss, m = TM.apply_train(model, _both(batch)[1])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert int(m["tokens"]) == int(jm["tokens"]) == b * s - 5
    assert model.embed.grad is None  # embeddings in: the table is unused
    assert not np.asarray(jgrads["embed"]["table"]).any()
    model.embed.grad = torch.zeros_like(model.embed)
    got = jax.tree_util.tree_leaves_with_path(
        weights.to_numpy_params(model, grads=True))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got) == len(ref)
    for path, g in got:
        want_g = np.asarray(ref[path])
        np.testing.assert_allclose(
            g, want_g, atol=1e-4 * max(float(np.abs(want_g).max()), 1e-30),
            rtol=0, err_msg=jax.tree_util.keystr(path))


def test_microbatches_equal_one_batch(fam):
    """`train_step` over 2 microbatches of [B, S, d] embeddings (and
    [3, B, S] positions, split on their batch axis) against one batch:
    the parameters after the step at 1e-6."""
    _, tcfg, _, params_np, _ = fam
    rng = np.random.default_rng(14)
    b, s = 4, 32
    batch = {"inputs": torch.from_numpy(rng.standard_normal(
                 (b, s, tcfg.d_model)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(
                 0, tcfg.vocab_size, size=(b, s)).astype(np.int32))}
    if tcfg.rope_style == "mrope":
        batch["positions"] = torch.from_numpy(patch_grid(b, s, seed=15))
    out = []
    for micro in (1, 2):
        model = weights.from_jax_params(tcfg, params_np, device="cpu")
        train_step(model, make_train_state(model), batch, microbatches=micro)
        out.append(list(model.parameters()))
    for a, c in zip(*out):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the packed engine against the JAX engine
# ---------------------------------------------------------------------------

CYCLE = [5, 9, 17, 3]


def _traces(vocab):
    """(prompts, new tokens, engine flags) by name."""
    rng = np.random.default_rng(0)
    draw = lambda lens: [list(map(int, rng.integers(1, vocab, size=n)))  # noqa: E731
                         for n in lens]
    return {
        "mixed": (draw([5, 40, 17, 70, 3, 33]), 6, {}),
        "chunked": (draw([90, 12, 47, 5]), 5,
                    dict(enable_chunked_prefill=True, max_prefill_tokens=32)),
        "preempting": (draw([40, 33, 47, 20]), 24,
                       dict(num_pages=13, max_model_len=128)),
        "speculative": ([CYCLE * 6, (CYCLE * 5)[:18]] + draw([9]), 12,
                        dict(speculative=True, draft_k=4)),
    }


@pytest.mark.parametrize("arch,trace", [
    (MUSICGEN, "mixed"), (QWEN2VL, "mixed"),
    (QWEN2VL, "chunked"), (QWEN2VL, "preempting"), (QWEN2VL, "speculative")])
def test_engine_matches_reference(built, arch, trace):
    jcfg, tcfg, params, _, model = built(arch)
    prompts, new, kw = _traces(jcfg.vocab_size)[trace]
    jeng = JEngine(jcfg, params, **(ENGINE | kw))
    jreqs = [JRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    jeng.generate(jreqs)
    teng = TEngine(tcfg, model, device="cpu", **(ENGINE | kw))
    treqs = [TRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    for r in treqs:
        teng.add_request(r)
    while teng.sched.has_work:
        H.assert_step_invariants(teng, teng.step())
    assert all(r.state is State.FINISHED for r in treqs)
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.step_idx == jeng.step_idx
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert repr(teng.compile_events) == repr(jeng.compile_events)
    assert teng.device_calls["unified"] == teng.step_idx
    if trace == "preempting":
        assert any(len(r.prompt) > len(p) for r, p in zip(treqs, prompts))
    if trace == "speculative":
        assert teng.spec_stats == jeng.spec_stats
        assert teng.spec_stats["accepted"] > 0
