"""Fault-tolerant checkpoint manager in the JAX package's on-disk format —
the port of ``repro.training.checkpoint``.

A checkpoint is ``step_{step:010d}/`` holding one ``.npy`` a leaf, named by
the first 24 hex digits of the SHA-256 of its key (the ``"/"``-joined path
of dict keys), and ``manifest.json`` (``sort_keys``): the step, ``meta``,
and each key's file, dtype, shape and SHA-256 of its bytes. Saving is
atomic and durable as in JAX: everything is written to ``step_….tmp``,
each file fsynced, then the tmp directory, then ``os.replace`` publishes it
and the parent directory is fsynced; ``keep`` bounds how many are kept.
``restore`` verifies every array against the manifest.

A tree is nested dicts whose leaves are tensors, numpy arrays or Python
ints (the optimiser's step, JAX's int32 scalar). A tree laid out as JAX
lays it out — ``{"params": models.convert.lm_to_jax(lm), "opt":
opt_state}``, the optimiser state keyed by the leaves' paths — gives the
keys, files and manifest JAX writes for the same arrays, so a checkpoint
written by either package restores in the other. bfloat16 tensors are not
taken (numpy has no bfloat16 of its own); ``lm_to_jax`` hands a bfloat16
model's leaves over as ml_dtypes arrays, which are.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.core.lowering import resolve_device


def _fsync_path(path: str) -> None:
    """fsync a file or directory by fd. Directory fsync pins the ENTRY
    (the name -> inode mapping) — required after create/rename for the
    operation itself to be durable, not just the bytes."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _leaf_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 tensor has no numpy dtype: pass the "
                            "parameters through models.convert.lm_to_jax")
        return x.detach().cpu().numpy()
    if isinstance(x, int):
        return np.asarray(x, dtype=np.int32)
    return np.asarray(x)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        return {prefix: _leaf_array(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_into(target, arrays: dict[str, np.ndarray], device,
                    prefix: str = ""):
    if isinstance(target, dict):
        return {k: _unflatten_into(v, arrays, device,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in target.items()}
    if prefix not in arrays:
        raise KeyError(f"checkpoint missing array {prefix!r}")
    a = arrays[prefix]
    shape = tuple(target.shape) if hasattr(target, "shape") else ()
    if tuple(a.shape) != shape:
        raise ValueError(f"{prefix}: shape {a.shape} != target {shape}")
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=target.dtype)
    if isinstance(target, int):
        return int(a)
    return a.astype(target.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, meta: dict | None = None) -> str:
        arrays = _flatten(tree)
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, a in arrays.items():
            fn = hashlib.sha256(key.encode()).hexdigest()[:24] + ".npy"
            path = os.path.join(tmp, fn)
            with open(path, "wb") as f:
                np.save(f, a)
                f.flush()
                os.fsync(f.fileno())    # array bytes durable before publish
            manifest[key] = {
                "file": fn, "dtype": str(a.dtype), "shape": list(a.shape),
                "sha256": hashlib.sha256(
                    np.ascontiguousarray(a).tobytes()).hexdigest(),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "meta": meta or {}, "arrays": manifest},
                      f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())        # manifest durable before publish
        _fsync_path(tmp)                # the tmp dir's entries themselves
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        _fsync_path(self.dir)           # …and durable: pin the rename
        self._prune()
        return final

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: int | None = None, *,
                device: str | torch.device = "cuda",
                verify: bool = True) -> tuple[int, Any]:
        """(step, ``target``'s tree with the checkpoint's arrays): tensors
        in the target's dtype on ``device``, numpy arrays in the target's
        dtype, ints as ints. Raises if an array is missing, misshapen or
        (``verify``) does not match its manifest digest."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {}
        for key, info in manifest["arrays"].items():
            a = np.load(os.path.join(d, info["file"]))
            if verify:
                dig = hashlib.sha256(
                    np.ascontiguousarray(a).tobytes()).hexdigest()
                if dig != info["sha256"]:
                    raise IOError(f"checkpoint array {key!r} is corrupt")
            arrays[key] = a
        return manifest["step"], _unflatten_into(target, arrays,
                                                 resolve_device(device))

    def meta(self, step: int) -> dict:
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["meta"]
