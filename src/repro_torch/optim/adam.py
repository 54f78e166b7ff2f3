"""Adam + the paper's cosine-with-reloads schedule.

Paper §4: "adam optimizer and cosine learning rate schedule, decaying across
4 epochs starting from 1e-4 and reloading at /2 (i.e. 5e-5, 2.5e-5 @
epoch=4,8)", 12 epochs total, no regularization.

The arithmetic is the JAX package's, operation for operation, in f32.  One
difference of form: :meth:`Adam.update` writes the new parameters and
moments into the given tensors (in place, in chunks) rather than returning
fresh trees — at full width a fresh tree of each would not fit beside the
teacher.  A leaf whose gradient is ``None`` (it received none) is updated
as if its gradient were zero, as JAX does with the zeros ``jax.grad``
returns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import tree_items, tree_map

#: elements per chunk of the in-place update (bounds its temporaries)
_CHUNK = 1 << 24


def cosine_reload_schedule(base_lr: float = 1e-4, steps_per_cycle: int = 1000,
                           n_cycles: int = 3, reload_factor: float = 0.5):
    """lr(t): cosine decay over each cycle; each reload halves the peak.
    Returns a 0-dim f32 tensor on the CPU."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        cycle = torch.clamp(torch.div(step, steps_per_cycle,
                                      rounding_mode="floor"),
                            max=n_cycles - 1)
        t = (step - cycle * steps_per_cycle) / steps_per_cycle
        t = torch.clamp(t, 0.0, 1.0)
        peak = base_lr * (reload_factor ** cycle)
        return 0.5 * peak * (1.0 + torch.cos(math.pi * t))
    return lr


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Any = 1e-4                     # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float | None = None
    state_dtype: torch.dtype = torch.float32   # bf16 for 100B+ models

    def init(self, params) -> dict:
        """``{"m", "v"}`` zeros beside each parameter, ``"step"`` a 0-dim
        int32 (CPU) tensor — the JAX package's state tree."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype,
                               device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads, state, params) -> tuple[Any, dict]:
        """One step; ``params``, ``state["m"]`` and ``state["v"]`` are
        updated in place and returned."""
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        lr = self.lr(step) if callable(self.lr) else self.lr
        scale = None
        if self.grad_clip is not None:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                for _, g in tree_items(grads)
                                if g is not None) + 1e-16)
            scale = torch.clamp(self.grad_clip / gn, max=1.0)
        bc1 = 1 - self.b1 ** stepf
        bc2 = 1 - self.b2 ** stepf
        m_tree, v_tree = state["m"], state["v"]
        with torch.no_grad():
            for path, p in tree_items(params):
                g, m, v = _at(grads, path), _at(m_tree, path), _at(v_tree, path)
                flat = [None if g is None else g.reshape(-1),
                        m.view(-1), v.view(-1), p.view(-1)]
                for a in range(0, p.numel(), _CHUNK):
                    g_, m_, v_, p_ = (t[a:a + _CHUNK] if t is not None
                                      else None for t in flat)
                    if g_ is not None and scale is not None:
                        g_ = g_ * scale.to(g_.dtype)
                    self._upd(g_, m_, v_, p_, lr, bc1, bc2)
        return params, {"m": m_tree, "v": v_tree, "step": step}

    def _upd(self, g, m, v, p, lr, bc1, bc2) -> None:
        m_new = self.b1 * m.to(torch.float32)
        v_new = self.b2 * v.to(torch.float32)
        if g is not None:
            gf = g.to(torch.float32)
            m_new = m_new + (1 - self.b1) * gf
            v_new = v_new + (1 - self.b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        p_new = p - lr * mhat / (torch.sqrt(vhat) + self.eps)
        p.copy_(p_new.to(p.dtype))
        m.copy_(m_new.to(self.state_dtype))
        v.copy_(v_new.to(self.state_dtype))


def _at(tree, path: tuple):
    for k in path:
        if tree is None:
            return None
        tree = tree[k]
    return tree


def paper_recipe(steps_per_epoch: int, epochs_per_cycle: int = 4,
                 base_lr: float = 1e-4,
                 state_dtype=torch.float32) -> Adam:
    """The exact QFT hyperparameters from the paper (§4)."""
    return Adam(lr=cosine_reload_schedule(
        base_lr, steps_per_cycle=steps_per_epoch * epochs_per_cycle,
        n_cycles=3), state_dtype=state_dtype)
