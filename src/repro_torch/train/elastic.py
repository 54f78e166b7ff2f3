"""Elastic / fault-tolerant training runner (the JAX package's
``train/elastic.py``).

- **Failure detection**: a step that raises :class:`StepFailure` (an
  injected failure, or a straggler past ``step_timeout_s``) or
  ``torch.distributed.DistBackendError`` (a lost rank or collective — the
  counterpart of ``jax.errors.JaxRuntimeError``) is caught; the runner
  re-forms the largest viable mesh from the surviving ranks
  (``launch.mesh.make_elastic_mesh``), rebuilds the step and restores the
  latest atomic checkpoint.  Nothing else is caught: a kernel fault (a
  ``RuntimeError``) propagates instead of hiding behind a restart.
- The data pipeline is seekable (``data/calib.py``), so after a restore
  at step ``s`` the runner calls ``data.skip_to(s)``: no sample is repeated
  or lost.
- Checkpoint ``k`` holds the state after exactly ``k`` completed steps
  (labelled after the increment), so a restore replays the run without the
  failure exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import torch.distributed as dist

from ..launch.mesh import make_elastic_mesh
from .checkpoint import CheckpointManager


class StepFailure(RuntimeError):
    pass


@dataclasses.dataclass
class ElasticConfig:
    step_timeout_s: float = 600.0
    checkpoint_every: int = 100
    max_restarts: int = 3
    model_parallel: int = 16


#: what a restart recovers from: an injected or straggler failure, a lost
#: rank or collective
RECOVERABLE = (StepFailure, dist.DistBackendError)


class ElasticRunner:
    """Drives (train_step, state, data) with checkpoint/restart semantics."""

    def __init__(self, build_step: Callable[[Any], Callable],
                 ckpt: CheckpointManager,
                 cfg: ElasticConfig = ElasticConfig(),
                 device_type: str | None = None):
        """``build_step(mesh) -> step_fn(state, batch) -> (state, metrics)``
        rebuilds the step for a (possibly shrunken) mesh, which
        ``make_elastic_mesh`` forms on ``device_type`` (``None``: the
        card; ``"cpu"`` for ``gloo``) over the initialised process
        group."""
        self.build_step = build_step
        self.ckpt = ckpt
        self.cfg = cfg
        self.device_type = device_type
        self.restarts = 0
        self.events: list[dict] = []

    def _available_devices(self) -> int:
        return dist.get_world_size()

    def _mesh(self):
        return make_elastic_mesh(self._available_devices(),
                                 self.cfg.model_parallel, self.device_type)

    def run(self, state: Any, data: Iterable[dict], steps: int,
            start_step: int = 0,
            inject_failure_at: int | None = None) -> tuple[Any, int]:
        step_fn = self.build_step(self._mesh())
        it = iter(data)
        s = start_step
        while s < steps:
            try:
                t0 = time.time()
                if inject_failure_at is not None and s == inject_failure_at:
                    inject_failure_at = None
                    raise StepFailure("injected device failure")
                batch = next(it)
                state, metrics = step_fn(state, batch)
                if time.time() - t0 > self.cfg.step_timeout_s:
                    raise StepFailure(f"straggler: step took "
                                      f"{time.time() - t0:.0f}s")
                s += 1
                # label AFTER incrementing: checkpoint k holds the state
                # with exactly k completed steps, so restore(k) + re-running
                # steps k..n-1 replays the no-failure run exactly
                if s < steps and s % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(s, {"state": state}, blocking=False)
            except RECOVERABLE as e:
                self.restarts += 1
                self.events.append({"step": s, "error": str(e)})
                if self.restarts > self.cfg.max_restarts:
                    raise
                # --- remesh + restore (the elastic path) ---
                step_fn = self.build_step(self._mesh())
                # drain in-flight async writes BEFORE asking for the latest
                # step: whether a non-blocking save has landed is a thread
                # race, and recovery must not depend on its timing
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                if last is not None:
                    state = self.ckpt.restore(last, {"state": state})["state"]
                    s = last
                if hasattr(data, "skip_to"):
                    data.skip_to(s)
                    it = iter(data)
        self.ckpt.wait()
        return state, s
