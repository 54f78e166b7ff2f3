"""Model-family adapters: one stage vocabulary over the registry.

The orchestrator (pipeline/runner.py) is family-agnostic; an adapter maps the
five pipeline stages onto the family's machinery — QFTTrainer and
serve/deploy for the dense transformer family, the only one the port has.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from ..core.distill import backbone_l2
from ..core.plan import STREAM_KEYS, QuantPlan, apply_plan, resolve_plan
from ..core.qconfig import QuantConfig
from ..data.calib import CalibConfig, CalibDataset
from ..device import resolve_device
from ..models import forward, init_model
from ..models.transformer import layer_slice, stack_depth
from ..serve.deploy import (DeployPlan, deploy_view, effective_view,
                            export_for_layers, kernel_route_check,
                            make_deploy_plan)
from ..train import qft_trainer
from ..train.checkpoint import CheckpointManager
from ..train.qft_trainer import QFTConfig, QFTTrainer
from ..tree import tree_items, tree_map
from .config import PipelineConfig

Params = dict[str, Any]


def resolve_quant_plan(model_cfg, qcfg: QuantConfig) -> QuantPlan:
    """Resolve the per-tensor QuantPlan for a registry config.

    The student skeleton is built on the meta device — shapes only, nothing
    allocated — so this is cheap at full width (what the
    ``python -m repro_torch plan`` CLI relies on).  Its keys are sorted, as
    ``jax.eval_shape`` returns them, so the plan lists its tensors in the
    JAX package's order."""
    def sort(tree):
        return ({k: sort(tree[k]) for k in sorted(tree)}
                if isinstance(tree, dict) else tree)

    shapes = sort(init_model(0, model_cfg, qcfg, device="meta"))
    return resolve_plan(qcfg, shapes, model_cfg=model_cfg)


def tree_parity_error(deployed: Params, effective: Params) -> float:
    """max |dequantize_export − effective_weight| over every exported leaf —
    the pipeline's export-fidelity acceptance metric.  Leaves are matched
    by path and compared one at a time in f32."""
    eff = dict(tree_items(effective))
    dep = dict(tree_items(deployed))
    if dep.keys() != eff.keys():
        raise ValueError(f"deployed and effective trees differ: "
                         f"{sorted(dep.keys() ^ eff.keys())}")
    err = 0.0
    for path, a in dep.items():
        b = eff[path]
        err = max(err, float(torch.max(torch.abs(
            a.to(torch.float32) - b.to(torch.float32)))))
    return err


def _parity_parts(student: Params, artifact: Params
                  ) -> Iterator[tuple[Params, Params]]:
    """(student part, artifact part) pairs covering the whole model: each
    top-level entry with the streams it is tied to, then each layer of the
    stack alone (a stack of depth 1) — so the two f32 views exist for one
    part at a time, never for the whole model."""
    streams = {k: student[k] for k in STREAM_KEYS & student.keys()}
    for k, v in student.items():
        if k in STREAM_KEYS:
            continue
        if k == "layers":
            for i in range(stack_depth(v)):
                yield tuple({k: tree_map(lambda x: x[None],
                                         layer_slice(tree, i))}
                            for tree in (v, artifact[k]))
        else:
            yield {k: v, **streams}, {k: artifact[k]}


# ---------------------------------------------------------------------------
# Dense transformer family
# ---------------------------------------------------------------------------

class TransformerAdapter:
    """The dense transformer family, via QFTTrainer's stage functions, on
    ``pcfg.device``."""

    def __init__(self, pcfg: PipelineConfig, model_cfg, qcfg: QuantConfig):
        if pcfg.smoke:
            model_cfg = dataclasses.replace(model_cfg, scan_layers=False,
                                            remat=False)
        self.pcfg = pcfg
        self.cfg = model_cfg
        self.qcfg = qcfg
        self.device = resolve_device(pcfg.device)
        # resolved ONCE; init, the finetune/degradation forwards, export and
        # serving all read this object — the train≡export grid invariant
        self.qplan = resolve_quant_plan(model_cfg, qcfg)
        self.data = CalibDataset(CalibConfig(
            n_samples=pcfg.calib_samples, seq_len=pcfg.calib_seq_len,
            batch_size=pcfg.calib_batch_size, vocab=model_cfg.vocab,
            seed=pcfg.seed))
        self._trainer: QFTTrainer | None = None

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- fixtures
    def _augment(self, batch: dict) -> dict:
        """Stub modality inputs for the VLM / enc-dec families, which the
        port does not have yet: the dense family's batch is the tokens."""
        return batch

    def batches(self):
        """Endless finetune batch iterator (family inputs attached)."""
        it = iter(self.data)
        while True:
            yield self._augment(next(it))

    def calib_batches(self) -> list[dict]:
        it = iter(CalibDataset(self.data.cfg))
        return [self._augment(next(it)) for _ in range(self.pcfg.calib_batches)]

    def init_teacher(self) -> Params:
        return init_model(self._gen(self.pcfg.seed), self.cfg, None,
                          device=self.device)

    def trainer(self, teacher: Params) -> QFTTrainer:
        if self._trainer is None:
            self._trainer = QFTTrainer(
                self.cfg, self.qcfg, teacher,
                QFTConfig(cle_init=self.pcfg.cle, base_lr=self.pcfg.base_lr,
                          checkpoint_every=self.pcfg.checkpoint_every),
                steps_per_epoch=self.data.steps_per_epoch, plan=self.qplan,
                use_kernels=self.pcfg.use_kernels)
        return self._trainer

    # --------------------------------------------------------------- stages
    def build_student(self, teacher: Params) -> Params:
        student = qft_trainer.build_student(
            self._gen(self.pcfg.seed + 1), self.cfg, self.qcfg, teacher,
            device=self.device)
        # reconcile log_swr shapes with the resolved plan (path-glob layout
        # overrides that bare-name init couldn't see)
        return apply_plan(student, self.qplan)

    def calibrate(self, student: Params, teacher: Params) -> Params:
        return qft_trainer.calibrate_student(
            student, self.cfg, self.qcfg, teacher, self.calib_batches(),
            use_kernels=self.pcfg.use_kernels)

    def init_scales(self, student: Params) -> Params:
        return qft_trainer.init_scales(student, self.cfg, self.qcfg,
                                       cle_init=self.pcfg.cle,
                                       plan=self.qplan)

    def finetune(self, student: Params, teacher: Params,
                 ckpt: CheckpointManager | None = None
                 ) -> tuple[Params, list[dict]]:
        if self.pcfg.steps <= 0:
            return student, []
        return self.trainer(teacher).run(
            student, self.batches(), steps=self.pcfg.steps,
            log_every=max(self.pcfg.log_every, 1), ckpt=ckpt,
            resume=self.pcfg.resume)

    def make_plan(self) -> DeployPlan:
        return make_deploy_plan(self.qcfg, arch=self.pcfg.arch,
                                family=self.cfg.family,
                                use_kernels=self.pcfg.use_kernels,
                                quant_plan=self.qplan)

    def export(self, student: Params, plan: DeployPlan) -> Params:
        with torch.no_grad():
            return export_for_layers(student, plan, device=self.device)

    # ------------------------------------------------------------- evaluate
    @torch.no_grad()
    def degradation(self, student: Params, teacher: Params) -> dict:
        losses, agree = [], []
        use = self.pcfg.use_kernels
        for batch in self.calib_batches()[: self.pcfg.eval_batches]:
            batch = qft_trainer._as_batch(batch, self.device)
            so = forward(student, self.cfg, self.qcfg, batch, plan=self.qplan,
                         use_kernels=use)
            to = forward(teacher, self.cfg, None, batch, use_kernels=use)
            losses.append(backbone_l2(so["hidden"], to["hidden"]))
            agree.append(torch.mean((torch.argmax(so["logits"], -1)
                                     == torch.argmax(to["logits"], -1))
                                    .to(torch.float32)))
            del so, to
        return {"distill_loss": float(torch.mean(torch.stack(losses))),
                "top1_agree": float(torch.mean(torch.stack(agree)))}

    @torch.no_grad()
    def evaluate(self, student: Params, teacher: Params, artifact: Params,
                 plan: DeployPlan) -> dict:
        metrics = self.degradation(student, teacher)
        metrics["w_layout"] = str(self.qcfg.layout)
        metrics["exempt"] = sorted(self.qplan.exempt_names)
        metrics["export_parity_max_err"] = max(
            tree_parity_error(deploy_view(a, plan, dtype=torch.float32),
                              effective_view(s, plan, dtype=torch.float32))
            for s, a in _parity_parts(student, artifact))
        metrics["artifact_bytes"] = int(sum(
            t.numel() * t.element_size() for _, t in tree_items(artifact)))
        if plan.use_kernels:
            check = kernel_route_check(artifact, plan)
            if check is not None:
                metrics["kernel_route"] = check
        if self.pcfg.serve_smoke:
            metrics["serve"] = self.serve_smoke(artifact, plan)
        return metrics

    def serve_smoke(self, artifact: Params, plan: DeployPlan) -> dict:
        from ..serve.engine import Engine, Request, ServeConfig
        cfg = dataclasses.replace(self.cfg, scan_layers=False, remat=False)
        engine = Engine.from_artifact(
            cfg, plan, artifact,
            ServeConfig(max_slots=self.pcfg.serve_max_slots, max_len=64,
                        prefill_chunk=self.pcfg.serve_prefill_chunk),
            device=self.device)
        pcfg = self.pcfg
        sampling = dict(temperature=pcfg.serve_temperature,
                        top_k=pcfg.serve_top_k, top_p=pcfg.serve_top_p)
        outs = engine.generate(
            [Request(prompt=[1, 2, 3], max_new_tokens=8,
                     seed=pcfg.serve_seed, **sampling),
             Request(prompt=[4, 5], max_new_tokens=4,
                     seed=pcfg.serve_seed + 1, **sampling)])
        if not (len(outs) == 2 and len(outs[0]) == 8 and len(outs[1]) == 4):
            raise RuntimeError(f"serve smoke emitted {outs}")
        return {"requests": 2, "tokens": sum(len(o) for o in outs),
                "max_slots": engine.scfg.max_slots,
                "temperature": pcfg.serve_temperature}


def get_adapter(pcfg: PipelineConfig) -> TransformerAdapter:
    model_cfg = pcfg.model_config()
    if getattr(model_cfg, "family", None) != "dense":
        raise KeyError(f"the port's pipeline runs the dense transformer "
                       f"family; {pcfg.arch!r} is {model_cfg.family!r}")
    return TransformerAdapter(pcfg, model_cfg, pcfg.quant_config())
