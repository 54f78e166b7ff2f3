"""The staged orchestrator: calibrate → init → finetune → export → evaluate.

One call (`run_pipeline`) takes a registry entry through the paper's
single-step PTQ flow with per-stage checkpointing/resume on top of
train/checkpoint.py.  Stage boundaries checkpoint the student tree; a rerun
with the same workdir skips every stage already on disk and picks up at the
first missing one.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any, Callable

import numpy as np
import torch

from ..train.checkpoint import CheckpointManager
from .adapters import TransformerAdapter, get_adapter
from .config import STAGES, PipelineConfig

Params = dict[str, Any]


@dataclasses.dataclass
class PipelineResult:
    pcfg: PipelineConfig
    model_cfg: Any
    qcfg: Any
    plan: Any
    teacher: Params
    student: Params
    artifact: Params | None
    metrics: dict[str, Any]
    stages_run: list[str]
    stages_skipped: list[str]
    history: list[dict]


def _stage_ckpt(pcfg: PipelineConfig) -> CheckpointManager | None:
    if pcfg.workdir is None:
        return None
    return CheckpointManager(str(pathlib.Path(pcfg.workdir) / "stages"),
                             keep=len(STAGES) + 1)


def _synchronize(device: torch.device) -> None:
    """A stage's time includes its kernels: wait for the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pipeline(pcfg: PipelineConfig,
                 log: Callable[[str], None] = lambda s: None,
                 adapter: TransformerAdapter | None = None) -> PipelineResult:
    """Run ``pcfg.stages()``.  ``adapter`` replaces the one ``pcfg``
    resolves — e.g. one built on a depth-cut model configuration."""
    if adapter is None:
        adapter = get_adapter(pcfg)
    stages = pcfg.stages()
    ckpt = _stage_ckpt(pcfg)

    teacher = adapter.init_teacher()
    student = adapter.build_student(teacher)

    # ---- resume: stage i's checkpoint is saved under step i+1 -------------
    finetune_no = STAGES.index("finetune") + 1
    done_through = 0
    if ckpt is not None and pcfg.resume:
        latest = ckpt.latest_step()
        if latest:
            done_through = min(latest, len(stages))
            like = {"student": student, "steps": np.asarray(0)}
            try:
                restored = ckpt.restore(done_through, like)
                if (done_through >= finetune_no and pcfg.steps > 0
                        and int(restored["steps"]) != pcfg.steps):
                    # different training budget than the checkpointed run:
                    # re-enter finetune from the post-init state (its own
                    # step checkpoints then continue or restart as needed).
                    # steps=0 means "no training requested" and accepts any
                    # checkpointed finetune state as-is.
                    done_through = finetune_no - 1
                    restored = ckpt.restore(done_through, like)
            except (ValueError, KeyError) as e:
                raise RuntimeError(
                    f"stage checkpoint in {pcfg.workdir!r} does not match "
                    f"this run's config (arch/mode/bits changed?): {e}. "
                    f"Use a fresh --workdir or --no-resume.") from e
            student = restored["student"]
            log(f"resumed after stage "
                f"{STAGES[done_through - 1]!r} from {pcfg.workdir}")

    artifact = None
    plan = adapter.make_plan()
    if plan.quant_plan is not None:
        ex = plan.quant_plan.exempt_names
        log(f"plan: {len(plan.quant_plan)} tensors"
            + (f", 1%-rule exempt: {', '.join(sorted(ex))}" if ex else ""))
    metrics: dict[str, Any] = {}
    history: list[dict] = []
    stages_run, stages_skipped = [], []

    fine_ckpt = None
    if pcfg.workdir is not None:
        fine_ckpt = CheckpointManager(
            str(pathlib.Path(pcfg.workdir) / "finetune"), keep=2)

    for i, stage in enumerate(stages):
        if i < done_through and stage not in ("export", "evaluate"):
            # student-mutating stages are covered by the restored checkpoint;
            # export/evaluate are cheap and re-derived from it every run
            stages_skipped.append(stage)
            continue
        t0 = time.time()
        if stage == "calibrate":
            student = adapter.calibrate(student, teacher)
        elif stage == "init":
            student = adapter.init_scales(student)
        elif stage == "finetune":
            student, history = adapter.finetune(student, teacher,
                                                ckpt=fine_ckpt)
            if history:
                metrics["finetune"] = {"first_loss": history[0]["loss"],
                                       "final_loss": history[-1]["loss"],
                                       "steps": pcfg.steps}
        elif stage == "export":
            artifact = adapter.export(student, plan)
        elif stage == "evaluate":
            # export always runs before evaluate (stages() is a prefix of
            # STAGES and export is never skipped on resume)
            metrics["evaluate"] = adapter.evaluate(student, teacher,
                                                   artifact, plan)
        stages_run.append(stage)
        _synchronize(adapter.device)
        log(f"stage {stage:<9s} done in {time.time() - t0:.1f}s")
        # a steps=0 finetune is a no-op: checkpointing it would make a later
        # training run on this workdir skip training entirely
        trained = stage != "finetune" or pcfg.steps > 0
        if ckpt is not None and trained and stage in ("calibrate", "init",
                                                      "finetune"):
            # "steps" records the training budget so a rerun with a
            # different --steps re-enters finetune instead of skipping it
            ckpt.save(i + 1, {"student": student,
                              "steps": np.asarray(pcfg.steps)})

    return PipelineResult(pcfg=pcfg, model_cfg=adapter.cfg, qcfg=adapter.qcfg,
                          plan=plan, teacher=teacher, student=student,
                          artifact=artifact, metrics=metrics,
                          stages_run=stages_run,
                          stages_skipped=stages_skipped, history=history)
