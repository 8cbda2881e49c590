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
