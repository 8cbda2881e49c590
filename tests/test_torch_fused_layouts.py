"""The fused weight layouts (`fused_qkv`: one `wqkv` for q | k | v;
`fused_mlp`: one `gate_up` for the SwiGLU's gate | up) against the JAX
reference on the CPU, fp32, weights of `M.init(cfg, key(0))`, on reduced
glm4-9b and qwen2.5-3b (`qkv_bias`: the fused bias) built as
tests/test_perf_variants.py builds them:

  * every registry architecture constructs a `Model` whose parameter tree
    is the reference's `M.init` tree, leaf for leaf and shape for shape,
    with and without both fused layouts;
  * `from_jax_params` / `to_numpy_params` round-trip the fused tree;
  * `apply_prefill` (rows of 24 and 13 of 24), `apply_decode` and
    `apply_unified` logits and pages against the reference's (1e-4);
  * `apply_train`'s loss (1e-5 relative) and every gradient leaf (1e-4 of
    its largest element) against `jax.grad(M.apply_train)`;
  * zamba2's shared decoder block with both layouts: prefill and decode
    logits, and the training gradient.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models import model as TM

FUSED = dict(fused_qkv=True, fused_mlp=True)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models are tiny: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(arch, **kw):
    kw = dict(dtype="float32", **kw)
    jcfg = jreduced(JARCHS[arch]).replace(**kw)
    tcfg = treduced(TARCHS[arch]).replace(**kw)
    params = jax.jit(lambda key: JM.init(jcfg, key))(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    return jcfg, tcfg, params, params_np, model


@pytest.fixture(scope="module", params=["glm4-9b", "qwen2.5-3b",
                                        "zamba2-1.2b"])
def fused(request):
    return _build(request.param, **FUSED)


def _shapes(tree):
    return {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("layout", ["unfused", "fused"])
@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_every_arch_builds_the_reference_tree(arch, layout):
    kw = FUSED if layout == "fused" else {}
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32", **kw)
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32", **kw)
    want = _shapes(jax.eval_shape(lambda: JM.init(jcfg, jax.random.key(0))))
    model = TM.Model(tcfg, device="meta")
    got = {}
    for path, i, t in weights._leaves(model):
        key = "".join(f"[{k!r}]" for k in path)
        shape = tuple(t.shape)
        if i is not None:  # stacked on the reference's leading [L] axis
            got[key] = (got.get(key, (0,))[0] + 1,) + shape
        else:
            got[key] = shape
    assert got == want


def test_weight_bridge_round_trips_the_fused_tree(fused):
    _, tcfg, _, params_np, model = fused
    back = weights.to_numpy_params(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(params_np))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(flat)
    names = {jax.tree_util.keystr(p) for p, _ in got}
    assert any("wqkv" in n for n in names) and any("gate_up" in n
                                                   for n in names)
    assert not any("['wq']" in n or "['gate']" in n for n in names)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, flat[path])


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def test_serving_entry_points_match_reference(fused):
    """Prefill of 2 rows (24 and 13 valid), a decode token each (the
    second slot dead); for the attention families a unified step of one
    decode row and one resumed chunk of 5."""
    jcfg, tcfg, params, _, model = fused
    rng = np.random.default_rng(3)
    b, s, np_, ps = 2, 24, 3, jcfg.page_size
    num_pages = b * np_ + 1
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    jcache = JM.make_cache(jcfg, max_seqs=b, num_pages=num_pages)
    tcache = TM.make_cache(tcfg, max_seqs=b, num_pages=num_pages,
                           device="cpu")
    qlens = np.asarray([24, 13], np.int32)
    ids = rng.integers(1, jcfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    jb, tb = _both({"inputs": ids[:, :s],
                    "positions": np.tile(np.arange(s, dtype=np.int32),
                                         (b, 1)),
                    "page_table": pt, "context_lens": qlens,
                    "query_lens": qlens})
    jl, jcache = jax.jit(functools.partial(JM.apply_prefill, jcfg))(
        params, jcache, jb)
    tl, tcache = TM.apply_prefill(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill",
                               **LOGIT_TOL)
    jb, tb = _both({"inputs": ids[:, s:], "positions":
                    np.asarray([[24], [-1]], np.int32), "page_table": pt,
                    "context_lens": np.asarray([25, 0], np.int32)})
    jl, jcache = jax.jit(functools.partial(JM.apply_decode, jcfg))(
        params, jcache, jb)
    tl, tcache = TM.apply_decode(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy()[:1], np.asarray(jl)[:1],
                               err_msg="decode", **LOGIT_TOL)
    for n in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tcache["attn"][n].numpy(),
                                   np.asarray(jcache["attn"][n]),
                                   err_msg=n, **LOGIT_TOL)
    if tcfg.family == "hybrid":
        return  # no packed step for the hybrid family
    p2 = np.concatenate([[25], 13 + np.arange(5)])
    seq = np.asarray([0, 1, 1, 1, 1, 1])
    jb, tb = _both({
        "inputs": rng.integers(1, jcfg.vocab_size, size=(1, 6)).astype(
            np.int32),
        "positions": p2[None].astype(np.int32), "page_table": pt,
        "context_lens": np.asarray([26, 18], np.int32),
        "query_lens": np.asarray([1, 5], np.int32),
        "query_start_loc": np.asarray([0, 1, 6], np.int32),
        "slot_mapping": (pt[seq, p2 // ps] * ps + p2 % ps)[None].astype(
            np.int32)})
    jl, jnew = jax.jit(functools.partial(JM.apply_unified, jcfg,
                                         num_decode_seqs=1))(
        params, jcache, jb)
    tl, tnew = TM.apply_unified(model, tcache["attn"], tb,
                                num_decode_seqs=1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="unified",
                               **LOGIT_TOL)


def test_apply_train_matches_reference(fused):
    jcfg, tcfg, params, params_np, _ = fused
    rng = np.random.default_rng(4)
    b, s = 2, 64
    batch = {"inputs": rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(
                 np.int32)}
    batch["labels"][1, -7:] = -1
    vag = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.apply_train(jcfg, p, bt), has_aux=True))
    (want, _), jgrads = vag(params, _both(batch)[0])
    model = weights.from_jax_params(tcfg, params_np,
                                    device="cpu").requires_grad_(True)
    loss, _ = TM.apply_train(model, _both(batch)[1])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    got = jax.tree_util.tree_leaves_with_path(
        weights.to_numpy_params(model, grads=True))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got) == len(ref)
    for path, g in got:
        want_g = np.asarray(ref[path])
        np.testing.assert_allclose(
            g, want_g, atol=1e-4 * max(float(np.abs(want_g).max()), 1e-30),
            rtol=0, err_msg=jax.tree_util.keystr(path))
