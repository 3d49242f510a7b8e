"""Fault detectors — the artifact checksum.

The port of the checksum detector of ``repro.faults.detect``: the deployment
artifact carries a per-array SHA-256 manifest, and ``integrity_errors``
re-hashes the runtime's in-memory (host) copy against it. The serving tier
runs it when it commissions a lane. The canary, board-trace and ECC
detectors need the fault models, not ported yet.
"""

from __future__ import annotations

import functools

from repro_torch.core.artifact import Artifact, array_hash
from repro_torch.telemetry import trace as ttrace


def _traced(kind: str):
    """Wrap a detector so each firing is a ``detect.<kind>`` system-scope
    span carrying the error count — a no-op until a Tracer is installed."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            rec = ttrace.get()
            if not rec.enabled:
                return fn(*args, **kw)
            sp = rec.begin(f"detect.{kind}", "system")
            errs = fn(*args, **kw)
            rec.end(sp, attrs={"errors": len(errs)})
            return errs
        return wrapper
    return deco


@_traced("checksum")
def integrity_errors(art: Artifact | None) -> list[str]:
    """Re-hash an artifact's arrays against its manifest. Empty list means
    intact; ``None`` or an artifact that was never exported (no manifest)
    is vacuously OK. Only the ARRAY bytes are checked: meta overrides (e.g.
    a host-side e_max change) are legitimate configuration."""
    if art is None or not art.meta.get("manifest"):
        return []
    manifest = art.meta["manifest"]
    bad = [name for name, digest in manifest.items()
           if name in art.arrays
           and array_hash(art.arrays[name]) != digest]
    missing = sorted(set(manifest) - set(art.arrays))
    errs = []
    if bad:
        errs.append(f"artifact integrity: array content hash mismatch for "
                    f"{sorted(bad)} — memory corrupted after export")
    if missing:
        errs.append(f"artifact integrity: manifest entries with no array: "
                    f"{missing}")
    return errs


def runtime_integrity_errors(runtime) -> list[str]:
    """Checksum detector applied to a constructed runtime's in-memory
    artifact copy (every runtime family keeps ``.art``)."""
    return integrity_errors(getattr(runtime, "art", None))
