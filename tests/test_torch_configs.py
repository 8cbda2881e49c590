"""The port's per-architecture config modules
(`repro_torch/configs/<arch>.py`): the reference's module map, one module
for each of `repro/configs/<arch>.py`, each `CONFIG` the port's registry
entry of the same architecture."""
import importlib
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS

REF_CONFIGS = Path(__file__).resolve().parents[1] / "src/repro/configs"
MODULES = sorted(p.stem for p in REF_CONFIGS.glob("*.py")
                 if p.stem not in ("__init__", "base", "registry"))


def test_ten_architecture_modules():
    assert len(MODULES) == 10


@pytest.mark.parametrize("module", MODULES)
def test_config_module_is_its_registry_entry(module):
    ref = importlib.import_module(f"repro.configs.{module}").CONFIG
    cfg = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    assert cfg is ARCHS[ref.name]
    assert cfg.name == ref.name


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_input_specs_match_reference(shape):
    """`input_specs` (meta tensors) against the reference's
    ShapeDtypeStructs: the same keys, shapes and dtypes for every
    architecture, with and without `pages_per_seq`; `SHAPES` and
    `shape_applies` alike."""
    import numpy as np

    from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
    from repro.configs.base import input_specs as j_input_specs
    from repro.configs.base import shape_applies as j_shape_applies
    from repro_torch.configs import SHAPES, input_specs, shape_applies

    assert list(SHAPES) == list(JSHAPES)
    js, ts = JSHAPES[shape], SHAPES[shape]
    assert (ts.name, ts.seq_len, ts.global_batch, ts.kind) == \
        (js.name, js.seq_len, js.global_batch, js.kind)
    for arch, jcfg in JARCHS.items():
        cfg = ARCHS[arch]
        assert shape_applies(cfg, ts) == j_shape_applies(jcfg, js)
        for kw in ({}, {"pages_per_seq": 7}):
            want = j_input_specs(jcfg, js, **kw)
            got = input_specs(cfg, ts, **kw)
            assert list(got) == list(want), (arch, shape)
            for key, w in want.items():
                g = got[key]
                assert g.device.type == "meta"
                assert tuple(g.shape) == tuple(w.shape), (arch, key)
                assert str(g.dtype).removeprefix("torch.") == \
                    np.dtype(w.dtype).name, (arch, key, g.dtype, w.dtype)
