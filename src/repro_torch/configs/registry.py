"""Name → model configuration, for the architectures the port runs: the
dense GQA transformers, the MoE family, DeepSeek-V2's MLA + MoE, the
Mamba2 SSM, the Zamba2 hybrid, the Qwen2-VL backbone (M-RoPE), the
SeamlessM4T encoder-decoder, and the paper's CNN.

The (arch × shape) cells of the dry-run: ``SHAPES`` (training at 4k,
prefill at 32k, decode at 32k and at 500k), ``skip_reason`` and
``cell_list``; ``input_specs`` gives the step's inputs of a cell as
shape-only (meta) tensors, nothing allocated.  Modality front ends (audio frames, vision patches) are
precomputed embeddings, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-7b": "zamba2_7b",
    "qwen3-32b": "qwen3_32b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-8b": "qwen3_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-1.3b": "mamba2_1_3b",
    "paper-cnn": "paper_cnn",
}

ARCH_IDS = [a for a in _MODULES if a != "paper-cnn"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: the SSM and the hybrid only
_SUBQUADRATIC = {"zamba2-7b", "mamba2-1.3b"}


def get_module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs "
                       f"{list(_MODULES)}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str, smoke: bool = False):
    m = get_module(arch)
    return m.SMOKE if smoke else m.CONFIG


def skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return "full-attention arch: 500k decode needs sub-quadratic attention"
    return None


def cell_list(include_skips: bool = False) -> list[tuple[str, str, str | None]]:
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            r = skip_reason(a, s)
            if r is None or include_skips:
                out.append((a, s, r))
    return out


def input_specs(arch: str, shape: str, cfg=None) -> dict[str, Any]:
    """Inputs for the step function of this (arch, shape) cell, as empty
    tensors on the meta device.

    train/prefill: the full-sequence batch.  decode: one new token per
    sequence (the cache is built separately, by the dry-run)."""
    cfg = cfg or get_config(arch)
    sp = SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    i32 = torch.int32
    d = cfg.d_model

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    fam = cfg.family
    if sp.kind == "decode":
        batch: dict[str, Any] = {"tokens": empty((B, 1), i32)}
        if fam == "vlm":
            batch["positions"] = empty((B, 3, 1), i32)
        return batch                  # encdec: the decoder token only
    if fam == "vlm":
        # dynamic-resolution stub: a quarter of the context is image patches
        s_img = S // 4
        return {"tokens": empty((B, S - s_img), i32),
                "patch_embeds": empty((B, s_img, d), torch.bfloat16),
                "positions": empty((B, 3, S), i32)}
    if fam == "encdec":
        # audio stub: S encoder frames, S // 8 decoder (text) tokens
        return {"frames": empty((B, S, d), torch.bfloat16),
                "tokens": empty((B, max(S // 8, 16)), i32)}
    return {"tokens": empty((B, S), i32)}
