"""The end-to-end quantization pipeline: calibrate → init → finetune →
export → evaluate, with per-stage checkpoint/resume (``python -m
repro_torch quantize``)."""
from .config import MODES, STAGES, PipelineConfig, canonical_arch
from .runner import PipelineResult, run_pipeline

__all__ = ["MODES", "STAGES", "PipelineConfig", "PipelineResult",
           "canonical_arch", "run_pipeline"]
