"""QFT trainer: the paper's single-step PTQ pipeline, end to end.

Pipeline (paper §4):
 1. take a pretrained FP network (the teacher);
 2. build the fake-quantized student with the SAME weights;
 3. the sole pre-QFT step: MMSE (PPQ/APQ) weight-scale init + naive max-min
    activation calibration (+ optional 4b-adapted CLE);
 4. finetune ALL DoF jointly — weights, biases, activation scales, rescale
    factors — with backbone-L2 distillation, Adam, cosine-reload schedule;
 5. export the deployment artifact (serve/deploy.py).

The JAX package's ``vmap`` over stacked layers is a loop over the leading
axis here, writing back into the stacked tensors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

import torch

from ..core import cle, dof
from ..core.calibration import stream_params_from_range
from ..core.mmse import ppq_scale
from ..core.plan import STREAM_OF, QuantPlan, _is_qlinear
from ..core.qconfig import Granularity, QuantConfig
from ..models import forward, init_model
from ..models.config import ModelConfig
from ..models.transformer import unstack
from ..optim.adam import paper_recipe
from ..tree import tree_from_items, tree_items, tree_map
from .checkpoint import CheckpointManager
from .steps import make_train_step

Params = dict[str, Any]

# tap name suffix → (module key, stream key) for calibration write-back
_TAP_TO_STREAM = {
    "attn_in": ("attn", "in_stream"),
    "attn.pre_o": ("attn", "out_stream"),
    "mlp_in": ("mlp", "in_stream"),
    "mlp.act": ("mlp", "act_stream"),
    "ssm_in": ("ssm", "in_stream"),
    "ssm.out": ("ssm", "out_stream"),
}

#: the stacked subtrees: each is walked one leading index at a time (the
#: JAX package's ``vmap``), so the hybrid's ``[G, attn_every]`` Mamba2
#: stack reaches the init one group ``[attn_every, ...]`` at a time
_STACKED = ("layers", "enc_layers", "dec_layers", "tail")


def _device_of(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def _per_layer(stacked: Params, fn) -> Params:
    """Apply ``fn`` to each layer slice of a stacked tree and stack the
    results (the JAX package's ``jax.vmap(fn)``).  A leaf ``fn`` returns
    untouched in every layer (the layer slice itself, e.g. a weight whose
    scales the init fits) is the stacked input leaf, not a stacked copy:
    a full-width model's weights are not held twice."""
    layers = unstack(stacked)
    outs = [dict(tree_items(fn(lp))) for lp in layers]
    ins = [dict(tree_items(lp)) for lp in layers]
    whole = dict(tree_items(stacked))

    def leaf(path):
        if path in whole and all(o[path] is i.get(path)
                                 for o, i in zip(outs, ins)):
            return whole[path]
        return torch.stack([o[path] for o in outs])

    return tree_from_items((path, leaf(path)) for path in outs[0])


def _init_scales_tree(tree: Params, qcfg: QuantConfig,
                      plan: QuantPlan | None = None) -> Params:
    """MMSE-init every qlinear's log_swr (PPQ; APQ for dchw, folding the
    left scale into the stream: ``log_sa = -log_swl``, the last sibling in
    key order writing it, as in the JAX package).  Per-tensor fit bits come
    from the plan; without one the role defaults apply.

    A hybrid group's Mamba2 weights reach the init as one ``[attn_every,
    in, out]`` stack, like an expert stack: APQ fits its layers jointly and
    gives them one geometric-mean ``S_wL``, as the JAX package's ``vmap``
    over the groups does (F17)."""

    def bits_at(path: tuple, default: int | None = None) -> int | None:
        if plan is not None:
            return plan.bits_for(".".join(path))
        return default

    def embed_init(v: Params) -> Params:
        srow = ppq_scale(v["w"], qcfg.embed_bits, axes=(1,),
                         iters=qcfg.mmse_iters)            # [V, 1]
        return {**v, "log_s": torch.log(torch.clamp(srow, min=1e-12))}

    def walk(node: Params, prefix: tuple) -> Params:
        if not isinstance(node, dict):
            return node
        if "log_s" in node and "w" in node:                # quantized embedding
            return embed_init(node)
        out = dict(node)
        for k, v in node.items():
            if isinstance(v, dict) and "log_s" in v and "w" in v:
                out[k] = embed_init(v)
            elif _is_qlinear(v):
                sname = STREAM_OF.get(k)
                stream = node.get(sname) if sname else None
                bits = bits_at(prefix + (k,))
                if qcfg.granularity is Granularity.DCHW:
                    newlin, log_swl = dof.apq_init_qlinear(v, qcfg, bits=bits)
                    out[k] = newlin
                    if stream is not None:
                        out[sname] = {**out[sname],
                                      "log_sa": out[sname]["log_sa"] * 0.0
                                      - log_swl}
                else:
                    log_sa = None if stream is None else stream["log_sa"]
                    out[k] = dof.mmse_init_qlinear(v, qcfg, bits=bits,
                                                   log_sa_in=log_sa)
            elif isinstance(v, dict):
                out[k] = walk(v, prefix + (k,))
        return out

    out = dict(tree)
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = _per_layer(v, lambda lp, k=k: walk(lp, (k,)))
        elif isinstance(v, dict):
            if _is_qlinear(v):
                sname = STREAM_OF.get(k)
                stream = tree.get(sname) if sname else None
                log_sa = None if stream is None else stream["log_sa"]
                bits = bits_at((k,), qcfg.embed_bits
                               if k in ("lm_head", "fc") else qcfg.w_bits)
                out[k] = dof.mmse_init_qlinear(v, qcfg, bits=bits,
                                               log_sa_in=log_sa)
            else:
                out[k] = walk(v, (k,))
        else:
            out[k] = v
    return out


def _copy_weights(student: Params, teacher: Params) -> Params:
    """Overwrite the student's w/b (master FP weights) with the teacher's,
    in the student's own buffers (no tensor is shared with the teacher)."""
    def walk(s, t):
        if isinstance(s, dict):
            return {k: walk(v, t[k]) if k in t else v for k, v in s.items()}
        if t is not None:
            with torch.no_grad():
                s.copy_(t)
        return s
    return walk(student, teacher)


def _as_batch(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def calibrate_student(student: Params, cfg: ModelConfig, qcfg: QuantConfig,
                      teacher: Params, batches: Iterable[dict],
                      use_kernels: bool = True) -> Params:
    """Naive max-min activation calibration (paper's pre-QFT step) from
    teacher taps; writes per-layer stream ``(log_sa, zp)`` into a new tree
    (the written leaves are fresh tensors; the input is unchanged).  Only
    ``L{i}`` taps are written back, as in the JAX package, so the hybrid's
    streams (``G.m{j}``, ``G.attn``, ``T{i}``) keep their init (F17).
    ``use_kernels`` routes the teacher's attention through the
    ``flash_attention`` kernel on the card."""
    if not qcfg.act_quant:
        return student
    dev = _device_of(teacher)
    acc: dict[str, tuple] = {}
    with torch.no_grad():
        for batch in batches:
            taps = forward(teacher, cfg, None, _as_batch(batch, dev),
                           collect_taps=True, logits=False,
                           use_kernels=use_kernels)["taps"]
            for name, st in taps.items():
                lo, hi = st["min"], st["max"]
                if name in acc:
                    lo = torch.minimum(lo, acc[name][0])
                    hi = torch.maximum(hi, acc[name][1])
                acc[name] = (lo, hi)

    new = tree_map(lambda x: x, student)
    fresh: set = set()
    for name, (lo, hi) in acc.items():
        layer_tag, _, suffix = name.partition(".")
        if not (layer_tag[:1] == "L" and layer_tag[1:].isdigit()):
            continue
        if suffix not in _TAP_TO_STREAM:
            continue                      # attn_out / mlp_out feed no stream
        module, stream = _TAP_TO_STREAM[suffix]
        sp = stream_params_from_range(lo, hi, qcfg, per_channel=False)
        leaves = new["layers"][module][stream]
        for k in ("log_sa", "zp"):
            if (module, stream, k) not in fresh:
                leaves[k] = leaves[k].clone()
                fresh.add((module, stream, k))
            leaves[k][int(layer_tag[1:])] = sp[k]
    return new


def cle_init_student(student: Params, cfg: ModelConfig,
                     qcfg: QuantConfig) -> Params:
    """4b-adapted CLE (Appendix D) on the transformer's norm-gain pivot:
    skew each in_stream's S_a by the consumers' MMSE slice/tensor
    log-ratios (β=−1 form: the residual producer is lossless, so the full
    benefit goes to the consumers)."""
    def walk(layer: Params) -> Params:
        out = dict(layer)
        for mod_name in ("attn", "mlp", "ssm"):
            mod = layer.get(mod_name)
            if not isinstance(mod, dict) or "in_stream" not in mod:
                continue
            consumers = [v["w"] for k, v in mod.items()
                         if _is_qlinear(v) and STREAM_OF.get(k) == "in_stream"
                         and v["w"].ndim == 2]
            if not consumers:
                continue
            log_c = cle.cle_factors(
                w_prev=torch.eye(consumers[0].shape[0],
                                 device=consumers[0].device),
                w_next_list=consumers,
                bits_prev=qcfg.w_bits,
                bits_next_list=[qcfg.w_bits] * len(consumers),
                cfg=qcfg, beta_override=-1.0)
            mod = dict(mod)
            mod["in_stream"] = {**mod["in_stream"],
                                "log_sa": cle.apply_cle_to_stream(
                                    mod["in_stream"]["log_sa"], log_c)}
            out[mod_name] = mod
        return out

    return {**student, **{k: _per_layer(student[k], walk)
                          for k in _STACKED if k in student}}


def build_student(gen: torch.Generator | int, cfg: ModelConfig,
                  qcfg: QuantConfig, teacher: Params, device=None) -> Params:
    """Stage: fake-quantized student skeleton with the teacher's FP weights
    (on ``device``; ``None`` → the card)."""
    student = init_model(gen, cfg, qcfg, device=device)
    return _copy_weights(student, teacher)


def init_scales(student: Params, cfg: ModelConfig, qcfg: QuantConfig,
                cle_init: bool = False,
                plan: QuantPlan | None = None) -> Params:
    """Stage: MMSE/APQ weight-scale init (+ optional CLE) — run AFTER
    calibrate_student so the S_a tie of Eq. 2 is inverted against the
    calibrated streams.  ``plan`` supplies per-tensor fit bits."""
    with torch.no_grad():
        student = _init_scales_tree(student, qcfg, plan=plan)
        if cle_init:
            student = cle_init_student(student, cfg, qcfg)
    return student


# -------------------------------------------------------------------------
# Step-checkpoint convention, shared by QFTTrainer.run and the pipeline:
# checkpoint number == completed steps.
# -------------------------------------------------------------------------

def restore_step_state(ckpt, like: dict, steps: int,
                       resume: bool) -> tuple[dict, int]:
    """(state, start_step) from the newest usable step checkpoint.

    A checkpoint beyond the requested step count can't produce the requested
    state — then (and with resume off / no checkpoint) train from scratch.
    """
    if not resume or ckpt is None:
        return like, 0
    latest = ckpt.latest_step()
    if not latest or latest > steps:
        return like, 0
    return ckpt.restore(latest, like), latest


def step_ckpt_due(completed: int, every: int, steps: int) -> bool:
    """Periodic save points; the final state is saved separately at ``steps``."""
    return completed % every == 0 and completed < steps


@dataclasses.dataclass
class QFTConfig:
    epochs: int = 12                  # paper (read by no stage, as in the
                                      # JAX package)
    ce_proportion: float = 0.0        # Fig. 6 ablation knob
    cle_init: bool = False            # Fig. 8: CLE+QFT two-step
    base_lr: float = 1e-4             # Fig. 7 robust region
    freeze_scales: bool = False       # Fig. 8/9 ablation: train W&b only
    checkpoint_dir: str | None = None  # step checkpoints when run() gets none
    checkpoint_every: int = 200


_SCALE_LEAVES = ("log_swr", "log_sa", "zp", "log_s")


def _freeze_scales_mask(path: tuple, g: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(g) if path[-1] in _SCALE_LEAVES else g


class QFTTrainer:
    """Drives the QFT finetune on the teacher's device.  ``plan`` (a
    resolved ``core.plan.QuantPlan``) threads per-tensor bits through both
    the MMSE scale init and the fake-quant training forward;
    ``microbatches`` accumulates each step's gradient over that many slices
    of the batch.  With ``use_kernels``, on the card, the student's weight
    fake-quant runs through the ``fake_quant`` kernel and the teacher's
    attention through ``flash_attention``."""

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, teacher: Params,
                 qft: QFTConfig = QFTConfig(), steps_per_epoch: int = 500,
                 plan: QuantPlan | None = None, microbatches: int = 1,
                 use_kernels: bool = True):
        self.cfg = cfg
        self.qcfg = qcfg
        self.teacher = teacher
        self.qft = qft
        self.plan = plan
        self.device = _device_of(teacher)
        self.opt = paper_recipe(steps_per_epoch=steps_per_epoch,
                                base_lr=qft.base_lr)
        self._grad_mask = _freeze_scales_mask if qft.freeze_scales else None
        self.train_step = make_train_step(
            cfg, qcfg, self.opt, ce_proportion=qft.ce_proportion,
            grad_mask=self._grad_mask, microbatches=microbatches, plan=plan,
            use_kernels=use_kernels)
        self.use_kernels = use_kernels

    # -------------------------------------------------------------- prepare
    def prepare_student(self, gen: torch.Generator | int,
                        calib_batches: Iterable[dict]) -> Params:
        student = build_student(gen, self.cfg, self.qcfg, self.teacher,
                                device=self.device)
        # order matters: calibrate S_a first, THEN invert Eq. 2 for S_wR
        student = calibrate_student(student, self.cfg, self.qcfg,
                                    self.teacher, calib_batches,
                                    use_kernels=self.use_kernels)
        return init_scales(student, self.cfg, self.qcfg,
                           cle_init=self.qft.cle_init, plan=self.plan)

    # ------------------------------------------------------------------ run
    def run(self, student: Params, data: Iterable[dict], steps: int,
            log_every: int = 50, ckpt: CheckpointManager | None = None,
            resume: bool = False) -> tuple[Params, list[dict]]:
        """``steps`` train steps over ``data``; the student is trained in
        place and returned with the logged ``{step, loss, t}`` history.

        With ``ckpt`` (or ``QFTConfig.checkpoint_dir``) the state is saved
        every ``checkpoint_every`` completed steps (in the background) and
        at the end; ``resume`` continues from the newest step checkpoint
        not past ``steps``, replaying ``data`` up to it (deterministic
        streams give the same batch per step index)."""
        if ckpt is None and self.qft.checkpoint_dir is not None:
            ckpt = CheckpointManager(self.qft.checkpoint_dir)
        state, start = restore_step_state(
            ckpt, {"student": student, "opt": self.opt.init(student)},
            steps, resume)
        student, opt_state = state["student"], state["opt"]
        history = []
        it = iter(data)
        for _ in range(start):
            next(it)
        t0 = time.time()
        for s in range(start, steps):
            batch = _as_batch(next(it), self.device)
            student, opt_state, metrics = self.train_step(
                student, opt_state, self.teacher, batch)
            if s % log_every == 0 or s == steps - 1:
                history.append({"step": s, "loss": float(metrics["loss"]),
                                "t": time.time() - t0})
            if ckpt is not None and step_ckpt_due(
                    s + 1, self.qft.checkpoint_every, steps):
                ckpt.save(s + 1, {"student": student, "opt": opt_state},
                          blocking=False)
        if ckpt is not None and steps > start:
            ckpt.save(steps, {"student": student, "opt": opt_state})
        for _, leaf in tree_items(student):
            leaf.requires_grad_(False)
        return student, history
