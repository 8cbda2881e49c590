from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    input_specs,
    positions_spec,
    shape_applies,
)
from repro_torch.configs.registry import ARCHS, get_config, reduced  # noqa: F401
