"""The serve step functions: chunked prefill and the slot-masked decode.

(The QFT training step of the JAX package is not ported yet.)
"""
from __future__ import annotations

from ..core.qconfig import QuantConfig
from ..core.sampling import sample_tokens
from ..models import forward
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, qcfg: QuantConfig | None, plan=None):
    """prefill_step(params, cache, batch) -> (next_token_logits, cache), for
    exact-length prompt chunks into a batch-1 cache."""

    def prefill_step(params, cache, batch):
        out = forward(params, cfg, qcfg, batch, cache=cache, plan=plan)
        return out["logits"][:, -1], out["cache"]

    return prefill_step


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
