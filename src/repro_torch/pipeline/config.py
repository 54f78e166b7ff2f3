"""Declarative configuration for the end-to-end quantization pipeline.

One ``PipelineConfig`` fully determines a run: which registry entry, which
paper setup (w4a8 deployment-oriented / w4chw permissive), calibration
budget, QFT step count, and where per-stage checkpoints land.  Every knob has
a CLI flag in pipeline/cli.py.  Field for field the JAX package's, except:
``use_pallas`` is ``use_kernels`` (default on, as ``DeployPlan``'s), and
``device`` picks the card (``"cuda"``) or the CPU, where every kernel's
plain version runs.
"""
from __future__ import annotations

import dataclasses

from ..configs import registry
from ..core.qconfig import (QLayout, QuantConfig, deployment_oriented,
                            permissive)

#: Stage order of the paper's single-step PTQ flow (§4).  ``evaluate`` is the
#: added repo stage: export-parity + degradation metrics + optional serve smoke.
STAGES = ("calibrate", "init", "finetune", "export", "evaluate")

MODES = ("w4a8", "w4chw")


def canonical_arch(name: str) -> str:
    """Accept both registry ids (``qwen3-8b``) and module names (``qwen3_8b``)."""
    if name in registry._MODULES:
        return name
    dashed = name.replace("_", "-")
    if dashed in registry._MODULES:
        return dashed
    for arch, module in registry._MODULES.items():
        if module == name:
            return arch
    known = ", ".join(sorted(registry._MODULES))
    raise KeyError(f"unknown config {name!r}; known: {known}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    arch: str = "paper-cnn"
    mode: str = "w4a8"                # w4a8 (deployment-oriented) | w4chw
    w_bits: int | None = None         # override the mode's weight bits
    w_layout: str | None = None       # weight-scale layout override:
                                      # layerwise | channel | group:<g>
    exempt_frac: float | None = None  # override the §4 1%-rule budget
                                      # (0 disables the exemption producer)
    bits_overrides: tuple = ()        # ((path-glob, bits), ...) plan rows
    layout_overrides: tuple = ()      # ((path-glob, layout spec), ...)
    smoke: bool = True                # registry SMOKE config (CPU-sized)
    steps: int = 60                   # QFT finetune steps (0 skips training)
    seed: int = 0
    cle: bool = False                 # CLE+QFT two-step (paper Fig. 8)
    base_lr: float = 1e-4
    teacher_steps: int = 0            # CNN only: pre-train the FP teacher
    # calibration budget (paper: ~8K samples; smoke default is far smaller)
    calib_samples: int = 512
    calib_seq_len: int = 32
    calib_batch_size: int = 16
    calib_batches: int = 4            # batches used for range calibration
    # evaluation / deployment smoke
    eval_batches: int = 2
    serve_smoke: bool = False         # transformer families: run the engine
    serve_max_slots: int = 4          # engine decode slot pool
    serve_prefill_chunk: int = 32     # prompt tokens prefilled per step
    serve_temperature: float = 0.0    # smoke sampling (0 = greedy)
    serve_top_k: int = 0              # smoke top-k truncation (0 disables)
    serve_top_p: float = 1.0          # smoke nucleus truncation (1 disables)
    serve_seed: int = 0               # smoke per-request sampling seed root
    use_kernels: bool = True          # the CUDA kernels for CUDA tensors
    device: str = "cuda"              # "cpu": every kernel's plain version
    # orchestration
    workdir: str | None = None        # enables per-stage checkpoint + resume
    resume: bool = True
    stop_after: str | None = None     # run a prefix of STAGES
    checkpoint_every: int = 200       # within-finetune step checkpoints
    log_every: int = 50

    def __post_init__(self):
        object.__setattr__(self, "arch", canonical_arch(self.arch))
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.w_layout is not None:
            QLayout.parse(self.w_layout)      # fail fast on bad CLI specs
        if self.stop_after is not None and self.stop_after not in STAGES:
            raise ValueError(f"stop_after must be one of {STAGES}")

    # ------------------------------------------------------------ resolution
    def model_config(self):
        return registry.get_config(self.arch, smoke=self.smoke)

    def quant_config(self) -> QuantConfig:
        qcfg = deployment_oriented() if self.mode == "w4a8" else permissive()
        if self.w_bits is not None and self.w_bits != qcfg.w_bits:
            qcfg = dataclasses.replace(qcfg, w_bits=self.w_bits)
        if self.w_layout is not None:
            qcfg = dataclasses.replace(qcfg,
                                       w_layout=QLayout.parse(self.w_layout))
        if self.exempt_frac is not None:
            qcfg = dataclasses.replace(qcfg, exempt_frac=self.exempt_frac)
        if self.bits_overrides:
            qcfg = dataclasses.replace(
                qcfg, bits_overrides=tuple(
                    (p, int(b)) for p, b in self.bits_overrides))
        if self.layout_overrides:
            qcfg = dataclasses.replace(
                qcfg, layout_overrides=tuple(self.layout_overrides))
        return qcfg

    def stages(self) -> tuple[str, ...]:
        if self.stop_after is None:
            return STAGES
        return STAGES[: STAGES.index(self.stop_after) + 1]
