"""Name → model configuration, for the architectures the port runs: the
dense GQA transformers, the MoE family and the paper's CNN."""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-32b": "qwen3_32b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-8b": "qwen3_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "paper-cnn": "paper_cnn",
}

ARCH_IDS = [a for a in _MODULES if a != "paper-cnn"]


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs "
                       f"{list(_MODULES)}")
    m = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return m.SMOKE if smoke else m.CONFIG
