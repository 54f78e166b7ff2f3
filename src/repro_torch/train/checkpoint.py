"""Fault-tolerant checkpointing: atomic, async-capable, keep-K.

- Atomic: write to ``<dir>/tmp.<step>`` then ``os.rename`` to
  ``step_<10 digits>`` — a crash mid-save never corrupts the latest
  checkpoint.
- One ``.npy`` per leaf and a ``manifest.json`` keyed by the leaf's path as
  the JAX package spells it (``['student']['layers']['attn']['wq']['w']``),
  so a directory written by either package restores in the other.
- Async: ``save(..., blocking=False)`` copies the state to the host first
  (the trainer updates its tensors in place right after) and writes the
  files from a worker thread.
- keep-K garbage collection + ``latest_step`` discovery for auto-resume.
- A DTensor leaf (the sharded train step's) is saved whole
  (``full_tensor``, a collective every rank joins) and restored onto the
  like leaf's mesh and placements.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _key(k) -> str:
    return f"[{k!r}]"


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path name, leaf)`` pairs in the JAX package's order (dict keys
    sorted) and spelling (``jax.tree_util.keystr``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], prefix + _key(k))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, prefix + f"[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves: dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + _key(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + f"[{i}]")
                          for i, v in enumerate(like))
    return leaves[prefix]


def _is_dtensor(leaf) -> bool:
    return hasattr(leaf, "full_tensor") and hasattr(leaf, "placements")


def _to_host(leaf) -> np.ndarray:
    """A host copy that later in-place updates of ``leaf`` cannot reach."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype to save as")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: dict, blocking: bool = True) -> None:
        host_state = [(name, _to_host(leaf)) for name, leaf in _flatten(state)]
        self.wait()                     # one writer at a time
        if blocking:
            self._write(step, host_state)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _write(self, step: int, host_state: list[tuple[str, np.ndarray]]
               ) -> None:
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {}
        for name, leaf in host_state:
            fname = f"leaf{len(manifest):05d}.npy"
            np.save(tmp / fname, leaf)
            manifest[name] = fname
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: dict, device=None) -> dict:
        """Restore into the structure of ``like``.  A tensor leaf comes back
        as a tensor on ``device`` (``None``: the like leaf's own device),
        any other leaf as a numpy array.  A leaf missing from the checkpoint
        raises ``KeyError``, a shape that differs ``ValueError``."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]
        leaves = {}
        for name, leaf_like in _flatten(like):
            arr = np.load(d / manifest[name])
            if arr.shape != tuple(np.shape(leaf_like)):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(np.shape(leaf_like))}")
            if _is_dtensor(leaf_like):
                from torch.distributed.tensor import distribute_tensor
                arr = distribute_tensor(
                    torch.from_numpy(arr).to(leaf_like.device),
                    leaf_like.device_mesh, leaf_like.placements)
            elif isinstance(leaf_like, torch.Tensor):
                arr = torch.from_numpy(arr).to(
                    leaf_like.device if device is None else device)
            leaves[name] = arr
        return _unflatten(like, leaves)
