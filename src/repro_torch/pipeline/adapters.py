"""Model-family adapters: one stage vocabulary over the registry.

The orchestrator (pipeline/runner.py) is family-agnostic; an adapter maps the
five pipeline stages onto the family's machinery — QFTTrainer and
serve/deploy for the transformer families (dense and MoE), the conv-specific
calibration/export path for the paper CNN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch

from ..core.calibration import stream_params_from_range
from ..core.cle import cle_factors
from ..core.distill import backbone_l2
from ..core.dof import mmse_init_qlinear
from ..core.plan import STREAM_KEYS, QuantPlan, apply_plan, resolve_plan
from ..core.qconfig import Granularity, QuantConfig
from ..data.calib import CalibConfig, CalibDataset
from ..device import resolve_device
from ..models import cnn as cnn_lib
from ..models import forward, init_model
from ..models.transformer import layer_slice, stack_depth
from ..optim.adam import Adam, paper_recipe
from ..serve.deploy import (DeployPlan, deploy_view, effective_view,
                            export_for_layers, kernel_route_check,
                            make_deploy_plan)
from ..train import qft_trainer
from ..train.checkpoint import CheckpointManager
from ..train.qft_trainer import QFTConfig, QFTTrainer
from ..tree import tree_from_items, tree_items, tree_map
from .config import PipelineConfig

Params = dict[str, Any]


def resolve_quant_plan(model_cfg, qcfg: QuantConfig,
                       producers: tuple = ()) -> QuantPlan:
    """Resolve the per-tensor QuantPlan for a registry config.

    The student skeleton is built on the meta device — shapes only, nothing
    allocated — so this is cheap at full width (what the
    ``python -m repro_torch plan`` CLI relies on).  Its keys are sorted, as
    ``jax.eval_shape`` returns them, so the plan lists its tensors in the
    JAX package's order.  ``producers`` run after the built-in chain
    (``core.plan.resolve_plan``)."""
    def sort(tree):
        if isinstance(tree, dict):
            return {k: sort(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [sort(v) for v in tree]
        return tree

    init = (cnn_lib.init_cnn if getattr(model_cfg, "family", None) == "cnn"
            else init_model)
    shapes = sort(init(0, model_cfg, qcfg, device="meta"))
    return resolve_plan(qcfg, shapes, model_cfg=model_cfg,
                        producers=producers)


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
# Transformer families (dense, MoE)
# ---------------------------------------------------------------------------

class TransformerAdapter:
    """The dense and MoE transformer families, via QFTTrainer's stage
    functions, on ``pcfg.device``."""

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


# ---------------------------------------------------------------------------
# Paper CNN (the paper's own experimental setting)
# ---------------------------------------------------------------------------

def _value_and_grad(loss_fn: Callable, params: Params, *args
                    ) -> tuple[torch.Tensor, Params]:
    """``(loss, grads)`` of ``loss_fn(params, *args)`` over every leaf of
    ``params`` (``None`` where no gradient reaches)."""
    items = list(tree_items(params))
    leaves = [t.requires_grad_() for _, t in items]
    loss = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_from_items(
        (path, g) for (path, _), g in zip(items, grads))


def _freeze(params: Params) -> Params:
    for _, leaf in tree_items(params):
        leaf.requires_grad_(False)
    return params


class CNNAdapter:
    """paper-cnn: conv streams chained per Eq. 2, backbone-feature KD, on
    ``pcfg.device``.  With ``use_kernels``, on the card, the student's
    weight fake-quant (every conv, and the fc where the logits are read)
    runs through ``fake_quant``.

    The synthetic task is drawn from ``torch.Generator``s with the JAX
    package's recipe (its ``jax.random`` draws are not reproduced); the
    stages take any ``x_calib``/``x_eval`` set on the adapter."""

    def __init__(self, pcfg: PipelineConfig, model_cfg, qcfg: QuantConfig):
        self.pcfg = pcfg
        self.cfg = model_cfg                    # CNNConfig
        self.qcfg = qcfg
        self.device = resolve_device(pcfg.device)
        self.qplan = resolve_quant_plan(model_cfg, qcfg)
        n = max(pcfg.calib_samples, 256)
        self.x_calib, self.y_calib = self._synth(self._gen(pcfg.seed), n)
        self.x_eval, self.y_eval = self._synth(self._gen(pcfg.seed + 99),
                                               512)

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _synth(self, gen: torch.Generator, n: int):
        """Separable synthetic task: smooth class templates + noise (the CNN
        analogue of the LM's self-teaching calibration stream).  The
        templates come from seed 777, the same in every call."""
        cfg, dev = self.cfg, self.device
        hw = cfg.img_hw
        grid = torch.arange(hw, dtype=torch.float32, device=dev) / hw
        modes = torch.stack([torch.cos(math.pi * f * grid)
                             for f in (0, 1, 2)])
        spatial = torch.einsum("ih,jw->ijhw", modes, modes).reshape(9, hw, hw)
        coef = torch.randn((cfg.n_classes, 9, cfg.in_ch),
                           generator=self._gen(777), device=dev)
        basis = torch.einsum("kfc,fhw->khwc", coef, spatial)
        basis = basis / torch.linalg.norm(
            basis.reshape(cfg.n_classes, -1), dim=1)[:, None, None, None] \
            * 12.0
        y = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev)
        x = basis[y] + torch.randn((n, hw, hw, cfg.in_ch), generator=gen,
                                   device=dev)
        return x.to(torch.float32), y

    def _forward(self, params: Params, qcfg, x: torch.Tensor, **kw) -> dict:
        return cnn_lib.forward_cnn(params, self.cfg, qcfg, x,
                                   use_kernels=self.pcfg.use_kernels, **kw)

    @torch.no_grad()
    def accuracy(self, params: Params, qcfg, plan=None) -> float:
        logits = self._forward(params, qcfg, self.x_eval,
                               plan=plan)["logits"]
        return float(torch.mean((torch.argmax(logits, -1) == self.y_eval)
                                .to(torch.float32)))

    def init_teacher(self) -> Params:
        teacher = cnn_lib.init_cnn(self._gen(self.pcfg.seed), self.cfg, None,
                                   device=self.device)
        steps = self.pcfg.teacher_steps
        if steps <= 0:
            return teacher
        opt = Adam(lr=3e-3)
        state = opt.init(teacher)
        x, y = self.x_calib, self.y_calib

        def loss_fn(p, xb, yb):
            logits = self._forward(p, None, xb)["logits"]
            lse = torch.log_softmax(logits, dim=-1)
            return -torch.mean(lse[torch.arange(len(yb)), yb])

        bs = min(128, len(x))
        for i in range(steps):
            j = (i * bs) % max(len(x) - bs, 1)
            _, g = _value_and_grad(loss_fn, teacher, x[j:j + bs],
                                   y[j:j + bs])
            teacher, state = opt.update(g, state, teacher)
        return _freeze(teacher)

    # --------------------------------------------------------------- stages
    def build_student(self, teacher: Params) -> Params:
        student = cnn_lib.init_cnn(self._gen(self.pcfg.seed + 1), self.cfg,
                                   self.qcfg, device=self.device)
        with torch.no_grad():       # the student's own buffers
            for conv, tconv in zip(student["convs"], teacher["convs"]):
                conv["w"].copy_(tconv["w"])
                conv["b"].copy_(tconv["b"])
            student["fc"]["w"].copy_(teacher["fc"]["w"])
            student["fc"]["b"].copy_(teacher["fc"]["b"])
        return apply_plan(student, self.qplan)

    @torch.no_grad()
    def calibrate(self, student: Params, teacher: Params) -> Params:
        """Naive max-min range calibration from teacher taps (paper §4);
        the fc stream shares PRE-pool feature scales (avg-pool is
        scale-preserving, §3.4)."""
        out = self._forward(teacher, None, self.x_calib[:256],
                            collect_taps=True)
        taps = out["taps"]
        for i in range(len(student["convs"])):
            t = taps[f"conv{i}.in"]
            student["streams"][i].update(stream_params_from_range(
                t["min"], t["max"], self.qcfg, per_channel=False))
        feats = out["features"].reshape(-1, out["features"].shape[-1])
        student["fc_stream"].update(stream_params_from_range(
            torch.amin(feats, 0), torch.amax(feats, 0), self.qcfg,
            per_channel=False))
        return student

    @torch.no_grad()
    def init_scales(self, student: Params) -> Params:
        """MMSE (PPQ) / APQ init of every conv's F̂ by inverting Eq. 2 under
        the calibrated stream ties; per-tensor fit bits (exempt convs, the
        fc head) come from the resolved QuantPlan."""
        qcfg, qplan = self.qcfg, self.qplan
        n = len(student["convs"])

        def out_stream(i):
            return (student["streams"][i + 1] if i + 1 < n
                    else student["fc_stream"])

        if qcfg.granularity is Granularity.DCHW:
            apq_t = {}
            for i, conv in enumerate(list(student["convs"])):
                newc, log_swl = cnn_lib.apq_init_qconv(
                    conv, qcfg, bits=qplan.bits_for(f"convs.{i}"))
                apq_t[i] = newc["log_f"]        # total right scale log t
                student["convs"][i] = newc
                student["streams"][i]["log_sa"] = -log_swl
            for i in range(n):                  # Eq. 4: F̂ = t / S_a_out
                student["convs"][i] = {
                    **student["convs"][i],
                    "log_f": apq_t[i] - out_stream(i)["log_sa"]}
        else:
            for i, conv in enumerate(list(student["convs"])):
                student["convs"][i] = cnn_lib.mmse_init_qconv(
                    conv, qcfg,
                    log_sa_in=student["streams"][i]["log_sa"],
                    log_sa_out=out_stream(i)["log_sa"],
                    bits=qplan.bits_for(f"convs.{i}"))
        student["fc"] = mmse_init_qlinear(
            student["fc"], qcfg, bits=qplan.bits_for("fc"),
            log_sa_in=student["fc_stream"]["log_sa"])
        if self.pcfg.cle and qcfg.granularity is not Granularity.DCHW:
            student = self._cle(student, out_stream)
        return student

    def _cle(self, student: Params, out_stream) -> Params:
        """4b-adapted CLE on the conv chain (paper App. D) + F̂ refit."""
        qcfg = self.qcfg
        for i in range(1, len(student["convs"])):
            wp = student["convs"][i - 1]["w"]
            w_prev = wp.reshape(-1, wp.shape[-1])
            wn = student["convs"][i]["w"]
            w_next = wn.permute(2, 0, 1, 3).reshape(wn.shape[2], -1)
            log_c = cle_factors(w_prev, [w_next], qcfg.w_bits, [qcfg.w_bits],
                                qcfg)
            student["streams"][i]["log_sa"] = \
                student["streams"][i]["log_sa"] + log_c
        for i in range(len(student["convs"])):
            student["convs"][i] = cnn_lib.mmse_init_qconv(
                student["convs"][i], qcfg,
                log_sa_in=student["streams"][i]["log_sa"],
                log_sa_out=out_stream(i)["log_sa"])
        return student

    def loss(self, student: Params, teacher: Params,
             x: torch.Tensor) -> torch.Tensor:
        """The finetune loss on one batch: backbone L2 between the
        student's and the (no-gradient) teacher's pre-pool features (the fc
        head is not run: the loss does not read it)."""
        fs = self._forward(student, self.qcfg, x, plan=self.qplan,
                           logits=False)["features"]
        with torch.no_grad():
            ft = self._forward(teacher, None, x, logits=False)["features"]
        return backbone_l2(fs.reshape(fs.shape[0], -1, fs.shape[-1]),
                           ft.reshape(ft.shape[0], -1, ft.shape[-1]))

    def loss_and_grads(self, student: Params, teacher: Params,
                       x: torch.Tensor) -> tuple[torch.Tensor, Params]:
        """One finetune step's ``(loss, grads)`` on the batch ``x``, before
        the update; the leaves the loss does not reach (the fc and the fc
        stream's zero-point) have ``None``."""
        return _value_and_grad(self.loss, student, teacher, x)

    def finetune(self, student: Params, teacher: Params,
                 ckpt: CheckpointManager | None = None
                 ) -> tuple[Params, list[dict]]:
        steps = self.pcfg.steps
        if steps <= 0:
            return student, []
        opt = paper_recipe(steps_per_epoch=max(steps // 3, 1),
                           base_lr=self.pcfg.base_lr)
        restored, start = qft_trainer.restore_step_state(
            ckpt, {"student": student, "opt": opt.init(student)}, steps,
            self.pcfg.resume)
        student, state = restored["student"], restored["opt"]
        x = self.x_calib
        bs = min(64, len(x))
        history = []
        for i in range(start, steps):
            j = (i * bs) % max(len(x) - bs, 1)
            loss, g = self.loss_and_grads(student, teacher, x[j:j + bs])
            student, state = opt.update(g, state, student)
            if i % max(self.pcfg.log_every, 1) == 0 or i == steps - 1:
                history.append({"step": i, "loss": float(loss)})
            if ckpt is not None and qft_trainer.step_ckpt_due(
                    i + 1, self.pcfg.checkpoint_every, steps):
                ckpt.save(i + 1, {"student": student, "opt": state})
        if ckpt is not None and steps > start:
            ckpt.save(steps, {"student": student, "opt": state})
        return _freeze(student), history

    def make_plan(self) -> DeployPlan:
        return make_deploy_plan(self.qcfg, arch=self.pcfg.arch, family="cnn",
                                use_kernels=self.pcfg.use_kernels,
                                quant_plan=self.qplan)

    def export(self, student: Params, plan: DeployPlan) -> Params:
        return cnn_lib.export_cnn(student, plan)

    # ------------------------------------------------------------- evaluate
    @torch.no_grad()
    def evaluate(self, student: Params, teacher: Params, artifact: Params,
                 plan: DeployPlan) -> dict:
        dv = cnn_lib.cnn_deploy_view(artifact, plan)
        ev = cnn_lib.cnn_effective_view(student, plan)
        metrics = {
            # convs keep the paper's lw/chw scale shapes; the group layout
            # applies to the fc qlinear only (QLayout falls back per layer)
            "w_layout": str(self.qcfg.layout),
            "exempt": sorted(self.qplan.exempt_names),
            "acc_teacher": self.accuracy(teacher, None),
            "acc_student": self.accuracy(student, self.qcfg,
                                         plan=self.qplan),
            "acc_deployed": self.accuracy(dv, None),
            "export_parity_max_err": tree_parity_error(dv, ev),
            "artifact_bytes": int(sum(
                t.numel() * t.element_size()
                for _, t in tree_items(artifact))),
        }
        if plan.use_kernels:
            check = kernel_route_check(artifact, plan)
            if check is not None:
                metrics["kernel_route"] = check
        return metrics


def get_adapter(pcfg: PipelineConfig):
    model_cfg = pcfg.model_config()
    qcfg = pcfg.quant_config()
    if getattr(model_cfg, "family", None) == "cnn":
        return CNNAdapter(pcfg, model_cfg, qcfg)
    return TransformerAdapter(pcfg, model_cfg, qcfg)
