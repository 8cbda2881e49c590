"""The port's expert-parallel MoE and gradient collectives
(`models/moe.py:moe_ffn_dropless_ep`, `distributed/collectives.py`)
against the JAX package, after tests/test_distributed.py.

Four gloo ranks on the CPU (started once for the module by
`spawn_ranks`, tests/torch_ranks.py:distributed_rank) run the EP MoE on
reduced deepseek-v2 in fp32 with the JAX init's weights, and the
collectives on the reference test's inputs; the JAX side runs here
(`moe_ffn_dropless`) and, for the collectives under `shard_map` on a
4-device host mesh, in a subprocess, as the reference test does.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro.configs import ARCHS, reduced
from repro.models.moe import init_moe, moe_ffn_dropless
from repro_torch.kernels.moe import kernel as GK
from repro_torch.kernels.moe import ops as GO
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.moe import shard_experts

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCH = "deepseek-v2-236b"
EF_STEPS = 50
# the reference test's inputs: rank r holds row r
GRADS = np.arange(32, dtype=np.float32).reshape(4, 8) / 7.3

# the reference's collectives under shard_map on 4 host devices; writes
# the one-step int8 sum and error feedback, the 50-step mean and the bf16
# sum of every device
JAX_COLLECTIVES = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import int8_ef_allgather, bf16_psum

mesh = jax.make_mesh((4,), ("data",))
x = jnp.arange(32, dtype=jnp.float32).reshape(4, 8) / 7.3

@jax.jit
def summed(x, ef):
    def body(xl, efl):
        tree, new_ef = int8_ef_allgather(xl[0], "data", efl[0])
        return tree[None], new_ef[None]
    return shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                     out_specs=(P("data"), P("data")))(x, ef)

@jax.jit
def bsum(x):
    def body(xl):
        return bf16_psum(xl[0], "data")[None]
    return shard_map(body, mesh=mesh, in_specs=(P("data"),),
                     out_specs=P("data"))(x)

ef = jnp.zeros((4, 8), jnp.float32)
s1, ef1 = summed(x, ef)
acc, efc = np.zeros((4, 8)), ef
for _ in range(%d):
    s, efc = summed(x, efc)
    acc += np.asarray(s)
np.savez(sys.argv[1], int8=np.asarray(s1), int8_ef=np.asarray(ef1),
         int8_mean=acc / %d, bf16=np.asarray(bsum(x)))
""" % (EF_STEPS, EF_STEPS)


def _jax_collectives(out: Path) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", JAX_COLLECTIVES, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' results, the JAX collectives, the JAX MoE reference):
    the ranks, the JAX subprocess and the in-process reference run side
    by side."""
    tmp = tmp_path_factory.mktemp("dist")
    cfg = reduced(ARCHS[MOE_ARCH]).replace(dtype="float32")
    p = jax.tree.map(np.asarray, init_moe(cfg, jax.random.key(0)))
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 16, cfg.d_model)))
    with ThreadPoolExecutor(max_workers=2) as pool:
        ranks = pool.submit(
            spawn_ranks, R.distributed_rank, 4, backend="gloo",
            init_file=str(tmp / "store"),
            args=(p, MOE_ARCH, x, GRADS, EF_STEPS))
        jax_coll = pool.submit(_jax_collectives, tmp / "jax.npz")
        ref, _ = moe_ffn_dropless(cfg, jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x))
        return dict(ranks=ranks.result(), jax=jax_coll.result(),
                    moe_ref=np.asarray(ref), moe_params=p, x=x, cfg=cfg)


@pytest.mark.parametrize("form", ["ep_cut", "ep_block"])
def test_ep_moe_matches_dropless(results, form):
    """moe_ffn_dropless_ep over 4 ranks (E 4 of reduced deepseek-v2, top
    2, 2 shared experts; each rank's own block of the experts, cut by
    `shard_experts`, or placed by an executor and reached through a
    block) equals the reference's moe_ffn_dropless at its 2e-5, on every
    rank."""
    for rank, res in enumerate(results["ranks"]):
        np.testing.assert_allclose(res[form], results["moe_ref"], atol=2e-5,
                                   rtol=2e-5, err_msg=f"rank {rank}")
        assert res["placed_experts"] == 1  # 4 experts over 4 ranks
        # one layout: a layer holding every expert is refused
        assert "needs the layer cut to its 1 experts" in res["held_error"]


def test_moe_block_goes_expert_parallel_in_an_expert_group(results):
    """A MoE block whose config sets `moe_ep_serve`, its experts placed by
    the executor under `use_expert_group`, runs `moe_ffn_dropless_ep`
    inside the group (once, with the bits of the direct call on the cut
    layer) and refuses to run outside it; a block outside any expert
    group keeps every expert and runs the plain dropless form."""
    for res in results["ranks"]:
        assert res["ep_block_calls"] == 1
        np.testing.assert_array_equal(res["ep_block"], res["ep_cut"])
        assert "holds 1 of its 4 experts" in res["cut_outside"]
        np.testing.assert_allclose(res["plain_block"], results["moe_ref"],
                                   atol=2e-5, rtol=2e-5)


def test_ep_moe_falls_back_when_experts_do_not_divide(results):
    """4 experts over 3 ranks: the plain dropless form on each."""
    for res in results["ranks"][:3]:
        np.testing.assert_allclose(res["ep_three"], results["moe_ref"],
                                   atol=2e-5, rtol=2e-5)


def test_shard_experts_cuts_the_rank_block(results):
    cfg = R.port_cfg(MOE_ARCH)
    moe = R.moe_from_numpy(cfg, results["moe_params"])
    w = moe.w_down.clone()
    shard_experts(moe, 2, 1)
    assert torch.equal(moe.w_down, w[2:])
    assert moe.router.w.shape[1] == 4
    with pytest.raises(ValueError, match="do not split"):
        shard_experts(R.moe_from_numpy(cfg, results["moe_params"]), 3, 0)


def test_grouped_gemm_tail_rows_match_ragged_dot():
    """The expert FFN with groups ending before the last row (`tail`): the
    rows past offsets[E] come out zero, as jax.lax.ragged_dot leaves
    them; without `tail` such offsets are refused."""
    rng = np.random.default_rng(5)
    r, d, ff = 11, 16, 24
    sizes = np.array([3, 0, 4], np.int32)  # 7 of 11 rows in groups
    xs = rng.standard_normal((r, d), np.float32)
    wg, wu = (rng.standard_normal((3, d, ff), np.float32) for _ in range(2))
    wd = rng.standard_normal((3, ff, d), np.float32)
    rd = lambda a, w: jax.lax.ragged_dot(  # noqa: E731
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(sizes))
    h = jax.nn.silu(rd(xs, wg)) * rd(xs, wu)
    want = np.asarray(rd(np.asarray(h), wd))
    offsets = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    got = GO.expert_ffn(*map(torch.from_numpy, (xs,)), offsets,
                        *map(torch.from_numpy, (wg, wu, wd)), tail=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[7:].any()
    with pytest.raises(ValueError, match="R = 11"):
        GK.grouped_gemm(torch.from_numpy(xs), torch.from_numpy(wg), offsets)
    with pytest.raises(ValueError, match="at most R = 11"):
        GK.grouped_gemm(torch.from_numpy(xs), torch.from_numpy(wg),
                        torch.tensor([0, 3, 3, 12], dtype=torch.int32),
                        tail=True)


def test_int8_error_feedback_allgather(results):
    """Every rank's int8 sum and error feedback within 1e-6 of the JAX
    functions' under shard_map; the reference's bounds: 0.02 of the exact
    sum after one step, 0.002 averaged over 50 steps with feedback."""
    exact = GRADS.sum(0)
    scale = np.abs(exact).max()
    jx = results["jax"]
    for rank, res in enumerate(results["ranks"]):
        np.testing.assert_allclose(res["int8"], jx["int8"][rank], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(res["int8_ef"], jx["int8_ef"][rank],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(res["int8_steps"].astype(np.float64)
                                   .mean(0), jx["int8_mean"][rank],
                                   atol=1e-6, rtol=0)
        assert np.abs(res["int8"] - exact).max() / scale < 0.02
        rel50 = np.abs(res["int8_steps"].mean(0) - exact).max() / scale
        assert rel50 < 0.002, rel50


def test_bf16_psum(results):
    """Every rank's bf16 sum within the reference's 0.01 of the exact sum,
    and of the JAX function's (its max difference from it is a bf16
    rounding of the sum's order: at most one bf16 ulp of the sum); leaves
    of a tree keep their dtype."""
    exact = GRADS.sum(0)
    scale = np.abs(exact).max()
    jx = results["jax"]["bf16"]
    for rank, res in enumerate(results["ranks"]):
        assert np.abs(res["bf16"] - exact).max() / scale < 0.01
        ulp = 2.0 ** (np.floor(np.log2(np.abs(jx[rank]))) - 7)
        assert (np.abs(res["bf16"] - jx[rank]) <= ulp).all(), \
            np.abs(res["bf16"] - jx[rank]).max()
        np.testing.assert_array_equal(res["bf16_tree"], 2 * res["bf16"])
        assert res["bf16"].dtype == np.float32
