"""Fault-tolerant checkpointing: the port of ``repro.checkpoint``.  Atomic
(write-temp + fsync + rename) npz checkpoints of the whole train state,
with retention, resume and corruption fallback: a process can die
mid-write and the previous checkpoint stays valid.

A state is a tree of NamedTuples, dicts and lists of tensors; leaves are
stored under their "/"-joined paths (``params/blocks/0/mamba/in_proj``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _items(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    items = _items(tree)
    if items is None:
        return {prefix: tree.detach().cpu().numpy()}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(template, flat: dict[str, np.ndarray], prefix: str = ""):
    """A tree shaped like ``template`` from ``flat``; each leaf takes the
    template leaf's dtype, device and ``requires_grad``."""
    items = _items(template)
    if items is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = flat[prefix]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"shape mismatch for {prefix}: "
                             f"{arr.shape} vs {tuple(template.shape)}")
        t = torch.from_numpy(arr).to(device=template.device,
                                     dtype=template.dtype)
        return t.requires_grad_(template.requires_grad)
    vals = [_unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in items]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*vals)
    if isinstance(template, dict):
        return dict(zip(template.keys(), vals))
    return type(template)(vals)


class Checkpointer:
    """Directory layout: <dir>/step_000123/state.npz + MANIFEST.json.
    The manifest is written last; a checkpoint without a valid manifest is
    treated as garbage (crash mid-write) and ignored/cleaned."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------- save --
    def save(self, state, step: int, extra: Optional[dict] = None) -> Path:
        final = self.dir / f"step_{step:09d}"
        tmp = Path(tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.dir))
        try:
            flat = _flatten(state)
            with open(tmp / "state.npz", "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
            manifest = {"step": step, "time": time.time(),
                        "n_leaves": len(flat), "extra": extra or {}}
            with open(tmp / "MANIFEST.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retain()
        return final

    def _retain(self):
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
        # clean stale temp dirs from crashed writers
        for p in self.dir.glob(".tmp_ckpt_*"):
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def list_steps(self) -> list[int]:
        return [int(p.name.split("_")[1])
                for p in sorted(self.dir.glob("step_*")) if self._valid(p)]

    def _valid(self, p: Path) -> bool:
        mf = p / "MANIFEST.json"
        if not mf.exists() or not (p / "state.npz").exists():
            return False
        try:
            with open(mf) as f:
                json.load(f)
            return True
        except (OSError, ValueError):
            return False

    def restore(self, template, step: int):
        p = self.dir / f"step_{step:09d}"
        with np.load(p / "state.npz") as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_like(template, flat)

    def restore_latest(self, template) -> Optional[tuple[Any, int]]:
        """Returns (state, step) from the newest VALID checkpoint, walking
        backwards past corrupted ones."""
        for step in reversed(self.list_steps()):
            try:
                return self.restore(template, step), step
            except Exception:  # any unreadable checkpoint: try an older one
                continue
        return None
