"""The QFT step functions and the serve steps.

train_step = teacher forward (FP, no grad) + student forward (fake-quant,
             offline subgraph inside) + backbone-L2 distillation + Adam.
prefill / decode / slot decode = the deployed inference graph (serve/,
             and the dry-run's inference cells).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.distill import qft_loss
from ..core.qconfig import QuantConfig
from ..core.sampling import sample_tokens
from ..models import forward, init_model
from ..models.config import ModelConfig
from ..optim.adam import Adam
from ..tree import tree_from_items, tree_items


def abstract_train_state(cfg: ModelConfig, qcfg: QuantConfig | None,
                         opt: Adam):
    """Shape-only ``(student, opt_state)`` on the meta device: what the
    static analyzer traces ``make_train_step`` against.  The teacher tree
    shares the student's shapes.  Nothing is allocated."""
    student = init_model(0, cfg, qcfg, device="meta")
    return student, opt.init(student)


def make_value_and_grad(cfg: ModelConfig, qcfg: QuantConfig | None,
                        ce_proportion: float = 0.0, microbatches: int = 1,
                        plan=None, compute_dtype=torch.bfloat16,
                        use_kernels: bool = True) -> Callable:
    """value_and_grad(student, teacher, batch, targets=None) -> (loss, grads).

    ``grads`` has the student's structure; a leaf that no gradient reaches
    (``lm_head`` and ``head_stream`` when ``ce_proportion == 0``: the head
    is then not run at all) is ``None``.  ``microbatches`` splits every
    batch leaf on axis 0 (``tokens``, and the VLM's ``patch_embeds`` and
    ``positions [B, 3, S]``, the encoder-decoder's ``frames``) and
    accumulates in f32 as the JAX package's ``lax.scan`` body does:
    ``acc + g / microbatches`` and the sum of ``loss / microbatches``.
    The teacher runs under ``torch.no_grad()``; ``use_kernels`` routes the
    student's weight fake-quant and the teacher's attention through the
    kernels on the card.  ``targets`` — the teacher's forward output
    (``{"hidden", "logits"}``) over the whole batch, computed once by the
    caller — replaces the teacher forward, so two routes can be held
    against each other on the same targets.
    """
    with_logits = ce_proportion > 0

    def loss_fn(student, teacher, batch, targets):
        s_out = forward(student, cfg, qcfg, batch, plan=plan,
                        compute_dtype=compute_dtype, use_kernels=use_kernels,
                        logits=with_logits)
        if targets is None:
            with torch.no_grad():
                targets = forward(teacher, cfg, None, batch,
                                  compute_dtype=compute_dtype,
                                  use_kernels=use_kernels, logits=with_logits)
        return qft_loss(s_out["hidden"], targets["hidden"], s_out["logits"],
                        targets["logits"], ce_proportion=ce_proportion)

    def value_and_grad(student, teacher, batch, targets=None):
        items = list(tree_items(student))
        leaves = [t.requires_grad_() for _, t in items]
        n_mb = max(microbatches, 1)
        rows = next(iter(batch.values())).shape[0]
        if rows % n_mb:
            raise ValueError(f"a batch of {rows} does not split into {n_mb} "
                             f"equal microbatches")
        size = rows // n_mb
        acc: list = [None] * len(leaves)
        losses = []
        for i in range(n_mb):
            rows_i = slice(i * size, (i + 1) * size)
            mb_targets = None if targets is None else {
                k: None if targets[k] is None else targets[k][rows_i]
                for k in ("hidden", "logits")}
            loss = loss_fn(student, teacher,
                           {k: v[rows_i] for k, v in batch.items()},
                           mb_targets)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for j, g in enumerate(grads):
                if g is not None:
                    g = g.to(torch.float32) / n_mb
                    acc[j] = g if acc[j] is None else acc[j].add_(g)
            del grads
            losses.append(loss.detach() / n_mb)
        return torch.sum(torch.stack(losses)), tree_from_items(
            (path, g) for (path, _), g in zip(items, acc))

    return value_and_grad


def make_train_step(cfg: ModelConfig, qcfg: QuantConfig | None, opt: Adam,
                    ce_proportion: float = 0.0, grad_compress=None,
                    grad_mask=None, microbatches: int = 1, plan=None,
                    compute_dtype=torch.bfloat16, use_kernels: bool = True,
                    value_and_grad=None):
    """train_step(student, opt_state, teacher, batch) -> (student, opt_state,
    {"loss", "grad_norm"}).

    ``grad_compress``: optional ``fn(grads, opt_state) -> (grads,
    opt_state)``, called after ``grad_mask`` and before the update, as in
    the JAX package (``train.compression.error_feedback_hook``: int8 with
    error feedback).
    ``grad_mask``: optional ``fn(path, g) -> g`` (``path`` a tuple of keys)
    — zero out DoF subsets for the paper's frozen-scales ablations.
    ``plan``: the resolved ``core.plan.QuantPlan`` — the student forward
    fake-quants each tensor at its plan bits.  ``use_kernels`` as in
    :func:`make_value_and_grad`.  The student's tensors and the optimizer
    state are updated in place (``optim.adam.Adam.update``).
    ``value_and_grad``: replaces :func:`make_value_and_grad`'s (the sharded
    step's, ``launch.train.build_step``).
    """
    if value_and_grad is None:
        value_and_grad = make_value_and_grad(
            cfg, qcfg, ce_proportion=ce_proportion,
            microbatches=microbatches, plan=plan,
            compute_dtype=compute_dtype, use_kernels=use_kernels)

    def train_step(student, opt_state, teacher, batch):
        loss, grads = value_and_grad(student, teacher, batch)
        if grad_mask is not None:
            grads = tree_from_items(
                (path, None if g is None else grad_mask(path, g))
                for path, g in tree_items(grads))
        if grad_compress is not None:
            grads, opt_state = grad_compress(grads, opt_state)
        student, opt_state = opt.update(grads, opt_state, student)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for _, g in tree_items(grads)
                               if g is not None))
        return student, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, qcfg: QuantConfig | None, plan=None):
    """prefill_step(params, cache, batch) -> (next_token_logits, cache), for
    exact-length prompt chunks into a batch-1 cache."""

    def prefill_step(params, cache, batch):
        out = forward(params, cfg, qcfg, batch, cache=cache, plan=plan)
        return out["logits"][:, -1], out["cache"]

    return prefill_step


def make_decode_step(cfg: ModelConfig, qcfg: QuantConfig | None, plan=None):
    """decode_step(params, cache, batch{tokens: [B, 1]}) -> (logits, cache):
    one greedy token over a monolithic cache (the dry-run's decode cells;
    the engine decodes through :func:`make_slot_decode_step`)."""

    def decode_step(params, cache, batch):
        out = forward(params, cfg, qcfg, batch, cache=cache, plan=plan)
        return out["logits"][:, -1], out["cache"]

    return decode_step


def make_bucketed_prefill_step(cfg: ModelConfig, qcfg: QuantConfig | None,
                               plan=None):
    """prefill_step(params, cache, batch, real_len) -> (logits, cache) for a
    right-padded chunk: causal attention keeps real queries off the pad keys,
    and the pad rows written into the cache sit at positions the decode mask
    never exposes; ``pos`` rolls back to the real length and the returned
    logits are the last real token's."""

    def prefill_step(params, cache, batch, real_len: int):
        B = batch["tokens"].shape[1]
        out = forward(params, cfg, qcfg, batch, cache=cache, plan=plan)
        cache = out["cache"]
        cache["pos"] = cache["pos"] - (B - real_len)
        return out["logits"][:, real_len - 1], cache

    return prefill_step


def make_slot_decode_step(cfg: ModelConfig, qcfg: QuantConfig | None,
                          plan=None, use_kernels: bool = True):
    """slot_decode_step(params, cache, state) -> (cache, state, emitted, emit)

    ONE shape-stable step over the whole slot pool.  Dead slots still run
    through the forward (the shapes never change) but their emissions are
    masked and their bookkeeping frozen.  The step emits the *current* token
    (prefill's draw on admission, the last step's draw after), updates done
    from eos/budget, then decodes the next one device-side from each slot's
    own sampling chain — its counter is the slot's emission count, so a
    request's k-th draw depends only on its (seed, k).
    """

    def slot_decode_step(params, cache, state):
        cur, done = state["cur"], state["done"]
        emit = ~done
        counts = state["counts"] + emit.to(state["counts"].dtype)
        done = done | (emit & (cur == state["eos"])) \
            | (counts >= state["budget"])
        out = forward(params, cfg, qcfg, {"tokens": cur[:, None]},
                      cache=cache, plan=plan, use_kernels=use_kernels)
        new_cur = sample_tokens(out["logits"][:, -1], state["seed"], counts,
                                state["temp"], state["top_k"], state["top_p"])
        new_state = {**state, "cur": new_cur, "done": done, "counts": counts}
        return out["cache"], new_state, cur, emit

    return slot_decode_step
