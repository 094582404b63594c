"""Checkpoint and restart, in the reference's file format.

Counterpart of `repro/train/checkpoint.py`: `step_%010d/arrays.npz` and
`manifest.json` (step, time, the npz's sha256, keys, shapes, dtypes,
meta), written under `.tmp_*` and published by `os.rename`, so a torn
write is never taken for a checkpoint; `keep` newest kept. A nested
dict's leaf is stored under its path in `jax.tree_util.keystr` form
(`"['params']['w']"`, `_safe`d), so a plain nested dict of arrays saved
by either package restores in the other. bfloat16 tensors are stored as
float32 (numpy has no bfloat16; the value is exact) and cast back on
restore. The reference's `shardings` argument comes with the mesh
(ROADMAP.md Queue 1, item 5h).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """{keystr path: leaf} of a nested dict (an empty dict holds no
    leaf), in the reference's sorted-key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
    return out


def _unflatten_like(like, leaves: dict, prefix: str = ""):
    if not isinstance(like, dict):
        return leaves[prefix]
    return {k: _unflatten_like(v, leaves, f"{prefix}[{k!r}]")
            for k, v in like.items()}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state, meta: dict | None = None) -> str:
        """Write `state` (a nested dict of tensors or arrays) as step
        `step`; returns the published directory."""
        arrays = {k: _to_numpy(v) for k, v in _flatten(state).items()}
        tag = f"step_{step:010d}"
        tmp = os.path.join(self.dir, f".tmp_{tag}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        data_path = os.path.join(tmp, "arrays.npz")
        np.savez(data_path, **{_safe(k): v for k, v in arrays.items()})
        manifest = {
            "step": int(step),
            "time": time.time(),
            "sha256": _sha256(data_path),
            "keys": {_safe(k): k for k in arrays},
            "shapes": {_safe(k): list(v.shape) for k, v in arrays.items()},
            "dtypes": {_safe(k): str(v.dtype) for k, v in arrays.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, tag)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None, validate: bool = True):
        """(a nested dict shaped as `like` — a nested dict of tensors
        giving shapes and dtypes — of new tensors on `device`, default
        each leaf's device; the manifest). Raises IOError when the payload fails its sha256,
        ValueError when a leaf's shape differs from `like`'s."""
        tag = f"step_{step:010d}"
        root = os.path.join(self.dir, tag)
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        data_path = os.path.join(root, "arrays.npz")
        if validate and _sha256(data_path) != manifest["sha256"]:
            raise IOError(f"checkpoint {tag} failed integrity check")
        leaves = {}
        with np.load(data_path) as z:
            for path, leaf in _flatten(like).items():
                k = _safe(path)
                arr = z[k]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"shape mismatch for {k}: ckpt {arr.shape} vs "
                        f"state {tuple(leaf.shape)}")
                leaves[path] = _to_tensor(arr).to(
                    device=leaf.device if device is None else device,
                    dtype=leaf.dtype)
        return _unflatten_like(like, leaves), manifest

    def restore_latest(self, like, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, like, device)


def _safe(key: str) -> str:
    return key.replace("/", "_")
