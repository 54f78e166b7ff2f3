"""Model configuration for the whole architecture pool.

One dataclass covers dense GQA / MoE / MLA / SSM / hybrid / enc-dec / VLM
backbones; family-specific fields are ignored elsewhere.  Every config in
configs/ instantiates this with published numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    n_experts_padded: int = 0      # EP divisibility padding (router-masked)
    capacity_factor: float = 1.25
    router_bits: int = 8           # router is tiny → exempt (paper 1% rule)

    def __post_init__(self):
        if self.n_experts_padded == 0:
            object.__setattr__(self, "n_experts_padded", self.n_experts)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "mla_moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (on half head_dim)
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    bias: bool = False
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0            # hybrid: one shared attn block every k layers
    enc_layers: int = 0            # encdec: encoder depth (n_layers = decoder)
    # --- distribution-time padding (function-preserving; see DESIGN.md §5) ---
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    vocab_padded: int = 0
    # --- runtime knobs ---
    remat: bool = True
    remat_policy: str = "full"     # full | save_dots | none (§Perf knob)
    scan_layers: bool = True
    mla_absorb: bool = False       # optimized MLA decode (matrix absorption)

    def __post_init__(self):
        for src, dst in (("n_heads", "n_heads_padded"),
                         ("n_kv_heads", "n_kv_heads_padded"),
                         ("vocab", "vocab_padded")):
            if getattr(self, dst) == 0:
                object.__setattr__(self, dst, getattr(self, src))

    def with_padding(self, tp: int) -> "ModelConfig":
        """Pad head/expert/vocab counts for TP/EP divisibility."""
        def up(x, m):
            return int(math.ceil(x / m) * m)
        kw: dict = {
            "n_heads_padded": up(self.n_heads, tp),
            "n_kv_heads_padded": (self.n_kv_heads if self.n_kv_heads < tp
                                  else up(self.n_kv_heads, tp)),
            "vocab_padded": up(self.vocab, 256 * tp // math.gcd(256, tp)),
        }
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts_padded=up(self.moe.n_experts, tp))
        return dataclasses.replace(self, **kw)

    # ---------------- analytic accounting (roofline §7) ----------------
    def param_count(self) -> dict[str, int]:
        """Logical (unpadded) parameter counts by component."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        out: dict[str, int] = {"embed": V * d}
        L_attn: int
        if self.family == "ssm":
            L_attn = 0
        elif self.family == "hybrid":
            L_attn = 1  # ONE shared attention block (Zamba weight sharing)
        elif self.family == "encdec":
            L_attn = self.enc_layers + 2 * self.n_layers  # self + cross
        else:
            L_attn = self.n_layers + (self.enc_layers or 0)
        if self.mla is not None:
            m = self.mla
            attn_l = (d * m.q_lora + m.q_lora * H * (m.d_nope + m.d_rope)
                      + d * (m.kv_lora + m.d_rope)
                      + m.kv_lora * H * (m.d_nope + m.d_v) + H * m.d_v * d)
            out["attn"] = self.n_layers * attn_l
        elif L_attn:
            attn_l = d * H * hd + 2 * d * Hkv * hd + H * hd * d
            out["attn"] = L_attn * attn_l
        else:
            out["attn"] = 0
        mlp_mult = 3 if self.mlp == "swiglu" else 2
        if self.moe is not None:
            e = self.moe
            per = mlp_mult * d * e.d_ff_expert
            out["experts"] = self.n_layers * e.n_experts * per
            out["shared_experts"] = self.n_layers * e.n_shared * per
            out["router"] = self.n_layers * d * e.n_experts
            out["mlp"] = 0
        else:
            n_mlp = self.n_layers + (self.enc_layers or 0)
            if self.family == "hybrid":
                n_mlp = 1  # shared block's MLP
            out["mlp"] = n_mlp * mlp_mult * d * ff if ff else 0
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            conv_dim = di + 2 * s.n_groups * s.d_state
            per = (d * (2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d))
                   + conv_dim * s.d_conv + di * d + 2 * s.n_heads(d))
            n_ssm = self.n_layers
            out["ssm"] = n_ssm * per
        out["head"] = 0 if self.tie_embeddings else V * d
        return out

    def n_params(self) -> int:
        return sum(self.param_count().values())

    def n_params_active(self) -> int:
        """Per-token active params (MoE top-k + shared; dense = all)."""
        if self.moe is None:
            return self.n_params()
        pc = self.param_count()
        e = self.moe
        dense = sum(v for k, v in pc.items()
                    if k not in ("experts", "shared_experts"))
        # routed: top_k of n_experts active per token; shared: always active
        return int(dense + pc["experts"] * e.top_k / e.n_experts
                   + pc["shared_experts"])
