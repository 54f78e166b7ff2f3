"""Mixed-precision exemption policy (paper §4).

"Instead [of exempting the first layer], for a flat overhead rate across nets,
we quantize in 8b a few smallest layers, added-up by increasing size till their
cumulative weight-memory footprint is 1% of the total across the backbone."

Wired into plan resolution as ``core.plan.exemption_rule`` — the producer
that turns this selection into per-tensor ``TensorSpec.w_bits``; every
consumer (init, export, deploy, serving) then reads the plan.  Selection
order is (size, name) ascending, so ties break deterministically and a layer
is included iff it still fits the cumulative budget exactly (``acc + size <=
budget``).
"""
from __future__ import annotations

from .qconfig import QuantConfig


def select_exempt_layers(layer_sizes: dict[str, int], cfg: QuantConfig) -> set[str]:
    """layer name → #weights.  Returns names kept at cfg.exempt_bits."""
    total = sum(layer_sizes.values())
    budget = cfg.exempt_frac * total
    exempt: set[str] = set()
    acc = 0
    for name, size in sorted(layer_sizes.items(), key=lambda kv: (kv[1], kv[0])):
        if acc + size > budget:
            break
        acc += size
        exempt.add(name)
    return exempt


def bits_for_layer(name: str, exempt: set[str], cfg: QuantConfig) -> int:
    return cfg.exempt_bits if name in exempt else cfg.w_bits
