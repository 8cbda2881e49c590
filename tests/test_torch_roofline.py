"""The port's roofline arithmetic (`repro_torch.roofline.analysis`) against
the reference's (`repro.roofline.analysis`, plain Python: no JAX runs
here), its counter on small steps, and the two-depth extrapolation
against the full-depth count of a dense train cell on a fake world."""
import numpy as np
import pytest
import torch

from repro.roofline import analysis as JRA
from repro.roofline import hw as jhw
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.roofline import analysis as RA

REF_RATES = dict(peak=jhw.PEAK_FLOPS_BF16, hbm=jhw.HBM_BW, link=jhw.ICI_BW)


def _depth_costs(rng):
    kinds = ("all-gather", "all-reduce", "reduce-scatter")
    out = {}
    for units in (2, 4):
        out[units] = (float(rng.integers(1, 10**12)),
                      float(rng.integers(1, 10**11)),
                      {k: float(rng.integers(0, 10**9))
                       for k in kinds[:rng.integers(1, 4)]})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_extrapolate_and_terms_match_reference(seed):
    """`extrapolate`, `terms` and `dominant` equal the reference's on the
    same inputs, with the reference's rates passed in."""
    rng = np.random.default_rng(seed)
    costs = _depth_costs(rng)
    full = float(rng.integers(5, 130))
    got, want = RA.extrapolate(costs, full), JRA.extrapolate(costs, full)
    assert (got.flops, got.bytes_hbm, got.coll_bytes) == \
        (want.flops, want.bytes_hbm, want.coll_bytes)
    assert got.coll_breakdown == want.coll_breakdown
    assert got.terms(**REF_RATES) == want.terms()
    assert got.dominant(**REF_RATES) == want.dominant()
    # and the port's own rates: the H100 data sheet's
    t = got.terms()
    assert t["compute_s"] == got.flops / 989e12
    assert t["memory_s"] == got.bytes_hbm / 3.35e12
    assert t["collective_s"] == got.coll_bytes / 50e9


@pytest.mark.parametrize("kw", [
    dict(batch_per_dev=16, seq=4096, heads=4, head_dim=512, chunk=64,
         n_layers=21),
    dict(batch_per_dev=2, seq=32768, heads=4, head_dim=512, chunk=64,
         n_layers=21),
    dict(batch_per_dev=1, seq=64, heads=2, head_dim=8, chunk=64,
         n_layers=3),
])
def test_scan_corrections_match_reference(kw):
    assert RA.mlstm_chunk_scan_correction(**kw) == \
        JRA.mlstm_chunk_scan_correction(**kw)
    skw = dict(batch_per_dev=kw["batch_per_dev"], seq=kw["seq"],
               d_model=kw["heads"] * kw["head_dim"] // 2,
               num_heads=kw["heads"], n_layers=kw["n_layers"] // 7 or 1)
    assert RA.slstm_time_scan_correction(**skw) == \
        JRA.slstm_time_scan_correction(**skw)


def test_counter_counts_ops_kernels_collectives_and_memory():
    """FLOPs of a matmul, bytes of its inputs and output, a recorded
    kernel and collective, and the peak of the storages made inside; a
    plain version inside `uncounted` adds nothing."""
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    with RA.StepCounter() as c:
        y = a @ b
        RA.record_kernel("k", 100, 10)
        RA.record_collective("all-reduce", 64)
        with RA.uncounted():
            z = torch.ones(1000) * 2  # noqa: F841
        tmp = torch.empty(256)
        del tmp
        out_bytes = c.fresh_bytes(y)
    assert c.aten_flops == 2 * 8 * 16 * 4
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.flops == c.aten_flops + 100 and c.total_bytes == c.bytes + 10
    assert c.kernels == {"k": [1, 100, 10]}
    assert c.collectives == {"all-reduce": 64}
    assert out_bytes == 8 * 4 * 4
    assert c.peak_bytes == 8 * 4 * 4 + 256 * 4
    # outside a counter, nothing is recorded and nothing fails
    RA.record_kernel("k", 1, 1)
    RA.record_collective("all-gather", 1)


def test_meta_kernels_record_their_work():
    """A kernel wrapper given meta tensors returns empty meta outputs of
    its kernel's shapes and records the work `analysis` gives for them."""
    from repro_torch.kernels.mamba2 import kernel as SK

    bsz, l, h, p, n, q = 2, 64, 4, 16, 8, 32
    meta = dict(device="meta")
    x = torch.empty(bsz, l, h, p, **meta)
    f32 = dict(dtype=torch.float32, **meta)
    with RA.StepCounter() as c:
        y, s = SK.ssd_chunked_fwd(
            x, torch.empty(bsz, l, h, **f32), torch.empty(bsz, l, 1, n, **meta),
            torch.empty(bsz, l, 1, n, **meta), torch.empty(bsz, l, h, **f32),
            torch.empty(bsz, h, n, p, **f32), chunk=q)
    assert y.device.type == "meta" and y.shape == x.shape
    assert s.shape == (bsz, h, n, p)
    want = RA.ssd_work(bsz=bsz, l=l, h=h, p=p, n=n, grp=1, q=q, e=4)
    assert c.kernels == {"ssd_chunked_fwd": [1, *want]}
    assert c.bytes == 0  # the outputs are allocations, not traffic


@pytest.fixture(scope="module")
def fake4():
    with fake_world(4):
        yield make_mesh((2, 2), ("data", "model"), device_type="cpu")


def test_two_depth_extrapolation_equals_full_depth(fake4):
    """A dense train cell (reduced qwen2.5-3b at 8 layers, bf16) on rank 0
    of a fake world of 4: the reference's two-depth extrapolation equals
    the full-depth count (relative 1e-9) in FLOPs, bytes and every
    collective kind."""
    cfg = reduced(ARCHS["qwen2.5-3b"]).replace(num_layers=8,
                                               dtype="bfloat16")
    shape = InputShape("t", 64, 4, "train")
    full = D.count_cell(cfg, shape, fake4, multi_pod=False)["count"].cost()
    ext = D.extrapolated_cost(cfg, shape, fake4, multi_pod=False)
    assert D.roofline_depths(cfg)[:2] == (2, 4)
    for got, want in ((ext.flops, full.flops),
                      (ext.bytes_hbm, full.bytes_hbm)):
        assert abs(got - want) <= 1e-9 * want, (got, want)
    assert set(ext.coll_breakdown) == set(full.coll_breakdown)
    for kind, want in full.coll_breakdown.items():
        assert abs(ext.coll_breakdown[kind] - want) <= 1e-9 * want, kind
    assert full.flops > 0 and full.coll_bytes > 0
