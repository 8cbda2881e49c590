from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.configs.registry import ARCHS, get_config, reduced  # noqa: F401
