"""The single deployment artifact — the paper's central abstraction.

One exported object carries weights, thresholds, connectivity descriptors and
grouped TTFS decoding metadata, and is consumed UNCHANGED by both the software
reference runner and the accelerator runtime. There is no board-specific
conversion stage that could silently change semantics.

Implementation: one ``.npz`` file holding the arrays plus a ``__meta__`` JSON
blob. The meta carries a manifest of per-array SHA-256 hashes and a whole-
artifact fingerprint; ``load`` verifies integrity so a corrupted or tampered
artifact fails loudly instead of silently flipping predictions.

A copy of ``repro.core.artifact``: the arrays stay numpy on the host, so
``array_hash`` sees ``int8`` (never ``torch.int8``) and the same ``.npz``
gives the same ``fingerprint()`` in both packages. ``from_numpy`` builds an
artifact from a meta dict and numpy arrays (what the tests use to hand the
JAX package's parameters to the port).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import io
import json
from typing import Any, Mapping

import numpy as np

FORMAT_VERSION = 2


def array_hash(a: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class Artifact:
    meta: dict[str, Any]
    arrays: dict[str, np.ndarray]

    # ------------------------------------------------------------------ io
    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for name in sorted(self.arrays):
            h.update(name.encode())
            h.update(array_hash(self.arrays[name]).encode())
        h.update(json.dumps(_strip_volatile(self.meta), sort_keys=True).encode())
        return h.hexdigest()

    def save(self, path: str) -> str:
        meta = dict(self.meta)
        meta["format_version"] = FORMAT_VERSION
        meta["manifest"] = {k: array_hash(v) for k, v in self.arrays.items()}
        self.meta = meta
        meta["fingerprint"] = self.fingerprint()
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
            **self.arrays)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return meta["fingerprint"]

    @classmethod
    def load(cls, path, verify: bool = True) -> "Artifact":
        """``path`` is a file name or a binary file object."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        art = cls(meta, arrays)
        if verify:
            art.verify()
        return art

    def verify(self) -> None:
        manifest = self.meta.get("manifest", {})
        missing = sorted(set(self.arrays) - set(manifest))
        orphaned = sorted(set(manifest) - set(self.arrays))
        if missing or orphaned:
            parts = []
            if missing:
                parts.append(f"arrays missing from manifest: {missing}")
            if orphaned:
                parts.append(f"manifest entries with no array: {orphaned}")
            raise IntegrityError("; ".join(parts))
        bad = [name for name, digest in manifest.items()
               if array_hash(self.arrays[name]) != digest]
        if bad:
            raise IntegrityError(
                f"array content hash mismatch for {bad} — the array bytes or "
                f"their manifest entry were modified after export")
        fp = self.meta.get("fingerprint")
        if fp is not None and fp != self.fingerprint():
            raise IntegrityError(
                "artifact fingerprint mismatch — the __meta__ blob (outside "
                "the per-array manifest) was modified after export")

    # -------------------------------------------------------- conveniences
    def __getitem__(self, name: str) -> np.ndarray:
        return self.arrays[name]

    def m(self, *path: str, default=None):
        """meta lookup: art.m('readout', 'n_groups')"""
        cur: Any = self.meta
        for p in path:
            if not isinstance(cur, Mapping) or p not in cur:
                return default
            cur = cur[p]
        return cur


class IntegrityError(RuntimeError):
    pass


def from_numpy(meta: Mapping[str, Any],
               arrays: Mapping[str, np.ndarray]) -> Artifact:
    """An artifact from a meta dict and numpy arrays, both copied (the
    caller's objects stay untouched); the fingerprint equals that of any
    artifact with the same meta and array bytes."""
    return Artifact(copy.deepcopy(dict(meta)),
                    {k: np.array(v) for k, v in arrays.items()})


def _strip_volatile(meta: dict) -> dict:
    return {k: v for k, v in meta.items() if k not in ("fingerprint", "manifest")}
