"""Quantization configuration (paper §4 experimental setups).

Two canonical setups from the paper, plus the knobs to express anything on the
lw/chw/dchw × W-bits × A-bits grid:

- ``deployment_oriented()``: W4A8, layerwise rescale factors → the only vector
  DoF is the cross-layer activation scale (CLE DoF), trained jointly.
- ``permissive()``: W4, FP activations, channelwise rescale → doubly-channelwise
  kernel quantization, two vector DoF per linear.

On top of the paper's granularity ladder sits the **weight-scale layout**
(``QLayout``): the granularity of the free S_wR factor along the kernel's
in/out axes.  ``layerwise`` and ``channel`` are the paper's two shapes;
``group(g)`` adds the W4 deployment layout used by LLM serving stacks — one
scale per ``g`` input channels per output channel, ``log_swr`` shaped
``[in/g, out]``.  The layout is a descriptor, not a fork: every consumer
(init, MMSE fit, fake-quant, export, the CUDA quant_matmul kernel) reads the scale's
shape, so new granularities are new descriptor values.
"""
from __future__ import annotations

import dataclasses
import enum


class Granularity(enum.Enum):
    LW = "lw"        # scalar rescale factor F̂ per linear (S_wR scalar)
    CHW = "chw"      # vector F̂ → per-out-channel S_wR
    DCHW = "dchw"    # chw + live CLE DoF → S_wL ⊗ S_wR (Corollary 2)


_LAYOUT_KINDS = ("layerwise", "channel", "group")


@dataclasses.dataclass(frozen=True)
class QLayout:
    """Granularity descriptor for the free weight-scale DoF (S_wR).

    kind:
      ``layerwise`` — one scalar per linear (``log_swr`` shape ``()``)
      ``channel``   — one scale per out-channel (``[out]``)
      ``group``     — one scale per (in-group, out-channel) block
                      (``[in/group, out]``); ``group`` is the block length
                      along the in-dim.

    When ``group`` does not divide a layer's in-dim the layer falls back to a
    single group spanning the whole in-dim (= channel granularity, but kept in
    the 2-D group shape so the code path stays uniform).
    """
    kind: str = "channel"
    group: int = 0                    # in-dim block length (kind == "group")

    def __post_init__(self):
        if self.kind not in _LAYOUT_KINDS:
            raise ValueError(f"layout kind must be one of {_LAYOUT_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "group" and self.group <= 0:
            raise ValueError(f"group layout needs a positive group size, "
                             f"got {self.group}")

    # ------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec: "QLayout | str") -> "QLayout":
        """``"layerwise" | "channel" | "group:<g>"`` (CLI spelling) → QLayout."""
        if isinstance(spec, cls):
            return spec
        s = spec.strip().lower()
        kind, sep, g = s.partition(":")
        if kind == "group":
            if not (sep and g.isdigit() and int(g) > 0):
                raise ValueError(f"group layout spec must be 'group:<size>', "
                                 f"got {spec!r}")
            return cls("group", int(g))
        if sep:
            raise ValueError(f"only group layouts take a size, got {spec!r}")
        return cls(kind)

    def __str__(self) -> str:
        return f"group:{self.group}" if self.kind == "group" else self.kind

    # ------------------------------------------------------------- shapes
    def n_groups(self, d_in: int) -> int:
        """Number of scale blocks along the in-dim (group layout only)."""
        assert self.kind == "group"
        return d_in // self.group if d_in % self.group == 0 else 1

    def swr_shape(self, d_in: int, d_out: int,
                  expert_dim: int | None = None) -> tuple[int, ...]:
        """The ``log_swr`` parameter shape for a ``[d_in, d_out]`` kernel."""
        lead = () if expert_dim is None else (expert_dim,)
        if self.kind == "layerwise":
            return lead
        if self.kind == "channel":
            return lead + (d_out,)
        return lead + (self.n_groups(d_in), d_out)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    w_bits: int = 4
    a_bits: int | None = 8            # None → FP activations ("permissive")
    granularity: Granularity = Granularity.DCHW
    w_layout: QLayout | None = None   # None → derived from granularity
    #: per-tensor layout overrides: ((path-glob, QLayout | spec str), ...).
    #: Patterns are fnmatch globs over the plan's path-qualified tensor name
    #: (``layers.mlp.down``, ``convs.0``); a pattern without ``.`` also
    #: matches the bare tensor name (old bare-name tuples keep working).
    layout_overrides: tuple = ()
    #: per-tensor weight-bit overrides, same path-glob grammar:
    #: ((path-glob, bits), ...).  Applied by core.plan.apply_overrides —
    #: the last producer before caller hooks, so they win over the 1%-rule.
    bits_overrides: tuple = ()
    exempt_bits: int = 8              # bits for exempted (smallest-1%) layers
    exempt_frac: float = 0.01         # cumulative weight-bytes fraction kept at
                                      # exempt_bits (paper's flat 1% rule, §4)
    embed_bits: int = 8               # embedding / LM-head precision
    kv_bits: int = 8                  # serve-time KV-cache precision (the KV
                                      # stream is a plan entry like any other
                                      # tensor class; 0 → keep cache in the
                                      # activation dtype, no plan entry)
    act_signed: bool = False          # paper: unsigned 8b activations
    mmse_iters: int = 10              # PPQ/APQ iterations at init

    @property
    def layout(self) -> QLayout:
        """The resolved default weight-scale layout.

        Explicit ``w_layout`` wins; otherwise the paper's granularity ladder
        maps to its two shapes (lw → layerwise, chw/dchw → channel).
        """
        if self.w_layout is not None:
            return QLayout.parse(self.w_layout)
        if self.granularity is Granularity.LW:
            return QLayout("layerwise")
        return QLayout("channel")

    def layout_for(self, name: str | None) -> QLayout:
        """Per-tensor layout: first matching ``layout_overrides`` glob wins,
        else the default.  ``name`` may be a bare linear name (init time) or
        a path-qualified plan name (resolution time) — the glob grammar
        (core.plan.glob_match) treats both consistently."""
        if name is not None:
            from .plan import glob_match
            for pat, layout in self.layout_overrides:
                if glob_match(pat, name):
                    return QLayout.parse(layout)
        return self.layout

    @property
    def swr_per_channel(self) -> bool:
        return self.layout.kind != "layerwise"

    @property
    def act_quant(self) -> bool:
        return self.a_bits is not None


def deployment_oriented(**kw) -> QuantConfig:
    """Paper's 'deployment-oriented' setup: 4b weights, 8b acts, layerwise F̂."""
    return QuantConfig(w_bits=4, a_bits=8, granularity=Granularity.LW, **kw)


def permissive(**kw) -> QuantConfig:
    """Paper's 'permissive' setup: 4b weights only, doubly-channelwise."""
    return QuantConfig(w_bits=4, a_bits=None, granularity=Granularity.DCHW, **kw)


def unquantized() -> QuantConfig | None:
    """Teacher / FP reference marker."""
    return None
