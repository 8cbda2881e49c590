"""Assigned-architecture config (see registry.py for the definition)."""
from repro_torch.configs.registry import ARCHS

CONFIG = ARCHS["llama3-405b"]

