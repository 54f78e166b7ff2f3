"""Name → model configuration, for the architectures the port serves."""
from __future__ import annotations

import importlib

_MODULES = {"qwen3-8b": "qwen3_8b"}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves {ARCH_IDS}")
    m = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return m.SMOKE if smoke else m.CONFIG
