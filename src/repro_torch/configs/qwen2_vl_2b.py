"""Assigned-architecture config (see registry.py for the definition)."""
from repro_torch.configs.registry import ARCHS

CONFIG = ARCHS["qwen2-vl-2b"]

