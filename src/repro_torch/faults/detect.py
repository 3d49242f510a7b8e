"""Fault detectors — how the serving tier notices something went wrong.

Each detector is matched to a fault class (the table in the README's
"Failure modes & resilience" section) and NONE of them peek at the injected
plan — they work from invariants the clean system already guarantees:

  checksum — the deployment artifact carries a per-array SHA-256 manifest;
             ``integrity_errors`` re-hashes the runtime's in-memory copy
             against it. Catches any static SEU in the weight / threshold
             blocks, at lane startup and per batch in paranoid mode.
  canary   — pinned probe images with known reference labels, one crafted
             per readout group (plus any user-supplied pool), re-classified
             through the lane's OWN serve path. Catches stuck-at groups and
             any corruption gross enough to move a known answer.
  trace    — the board runtime records the per-tick AER dispatch histogram;
             ``trace_errors`` recomputes the expected histogram from the
             TTFS encoder and re-evaluates the ``BoardCostModel`` account
             from it. Catches AER drop/duplicate/cross-tick displacement
             and any cycle/energy-account anomaly.
  ecc      — the membrane-BRAM parity model (``MembraneUpsetInjector``)
             surfaces per-image hit counts on the runtime
             (``last_ecc``); ``ecc_errors`` reads them. Catches transient
             membrane SEUs the instant they land, as parity does on-board.

The port of ``repro.faults.detect``, on host numpy as there: the canary's
crafted probes are built in float64 numpy from ``w_float`` (a float32 torch
version would move the probe images, and with them the kept set); their
reference labels come from the port's ``SNNReference`` on the program's
device; the trace detector re-encodes in float32 on the host, as the board
does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

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
    intact; ``None`` (a runtime that exposes no artifact) or an in-memory
    artifact that was never exported (no manifest to check against) is
    vacuously OK. Only the ARRAY bytes are checked — that is what BRAM SEUs
    can hit; meta overrides (e.g. a host-side e_max change) are legitimate
    configuration, which is why this does not use the stricter full-
    fingerprint ``Artifact.verify``."""
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


# --------------------------------------------------------------------- canary
@dataclasses.dataclass
class Canary:
    """Golden probe set: images whose reference labels are pinned at build
    time. ``mismatches(got)`` is the detector; coverage records which
    readout groups own at least one in-group probe (a stuck-at fault in a
    covered group is guaranteed to move that probe's label)."""

    images: np.ndarray        # (P, n_in) float32
    want: np.ndarray          # (P,) int32 reference labels
    covered_groups: tuple[int, ...]
    n_groups: int

    @property
    def covers_all_groups(self) -> bool:
        return len(self.covered_groups) == self.n_groups

    @_traced("canary")
    def mismatches(self, got_labels) -> list[str]:
        if isinstance(got_labels, torch.Tensor):
            got_labels = got_labels.cpu().numpy()
        got = np.asarray(got_labels)[: len(self.want)]
        bad = np.nonzero(got != self.want)[0]
        return [f"canary probe {int(i)}: served label {int(got[i])} != "
                f"pinned reference label {int(self.want[i])}" for i in bad]

    @classmethod
    def from_program(cls, program,
                     pool: np.ndarray | None = None) -> "Canary":
        """Build the probe set from a lowered program: candidate images are
        the ``pool`` (held-out real samples — preferred) plus one crafted
        probe per readout group (the group's positive float-weight mass, the
        input that drives it hardest). Reference labels are evaluated once on
        ``SNNReference``; one probe is kept per distinct label. A saturated
        stuck-at group is guaranteed to move at least one probe's label
        whenever the set spans two or more labels."""
        from repro_torch.core.reference import SNNReference
        n_groups = program.n_groups
        per_group = program.per_group
        x_min = program.x_min
        w = np.asarray(program.artifact["w_float"], np.float64)
        crafted = []
        for g in range(n_groups):
            drive = np.clip(w[:, g * per_group:(g + 1) * per_group],
                            0.0, None).sum(axis=1)
            peak = float(drive.max())
            x = drive / peak if peak > 0 else np.zeros_like(drive)
            # keep strong pixels comfortably above the encoder's threshold
            crafted.append(np.where(x >= x_min, x, 0.0).astype(np.float32))
        cands = np.stack(crafted)
        if pool is not None:
            cands = np.concatenate([np.asarray(pool, np.float32)[:256],
                                    cands])
        ref = SNNReference(program, device=program.device)
        want = ref.forward(cands).labels.cpu().numpy().astype(np.int32)
        keep: dict[int, int] = {}
        for i, lab in enumerate(want):
            keep.setdefault(int(lab), i)
        idx = sorted(keep.values())
        return cls(images=cands[idx], want=want[idx],
                   covered_groups=tuple(sorted(keep)), n_groups=n_groups)

    @classmethod
    def from_artifact(cls, art: Artifact, pool: np.ndarray | None = None, *,
                      device: str | torch.device = "cuda") -> "Canary":
        from repro_torch.core.lowering import lower
        return cls.from_program(lower(art, device=device), pool=pool)


# ---------------------------------------------------------------------- trace
@_traced("trace")
def trace_errors(runtime, images: np.ndarray) -> list[str]:
    """Board-trace cross-check: re-encode the served images, rebuild the
    expected per-tick AER dispatch histogram and the full
    ``BoardCostModel`` account from it, and compare against what the
    runtime actually dispatched (``last_tick_counts``) and charged
    (``last_trace``). Only meaningful for full-window board runtimes —
    returns [] for runtimes that expose no tick histogram or run
    latency-mode early exit."""
    actual = getattr(runtime, "last_tick_counts", None)
    trace = getattr(runtime, "last_trace", None)
    if actual is None or trace is None or getattr(runtime, "latency_mode",
                                                  False):
        return []
    from repro_torch.board.energy import account
    from repro_torch.core import ttfs
    from repro_torch.core.events import step_counts

    T = int(runtime.T)
    times = ttfs.encode_ttfs(
        torch.from_numpy(np.atleast_2d(np.asarray(images, np.float32))), T,
        runtime.x_min).numpy()
    expect = step_counts(times, T)[:, :T].astype(np.int64)
    errs: list[str] = []
    actual = np.asarray(actual, np.int64)
    if actual.shape != expect.shape:
        return [f"trace: tick-histogram shape {actual.shape} != expected "
                f"{expect.shape}"]
    bad = np.nonzero(np.any(actual != expect, axis=1))[0]
    if bad.size:
        i = int(bad[0])
        errs.append(
            f"trace: AER tick histogram diverges on {bad.size} images "
            f"(image {i}: dispatched {int(actual[i].sum())} events vs "
            f"{int(expect[i].sum())} scheduled — drop/duplicate/displace)")
    depth = int(runtime.depth)
    stalls = np.maximum(expect - depth, 0).sum(axis=1)
    want_tr = account(expect.sum(axis=1), np.full(len(expect), T, np.int64),
                      stalls, runtime.n_pad, runtime.cost)
    for f in dataclasses.fields(want_tr):
        a = np.asarray(getattr(want_tr, f.name))
        b = np.asarray(getattr(trace, f.name))
        if a.shape == b.shape and not np.array_equal(a, b):
            errs.append(f"trace: cost-model account anomaly in {f.name} "
                        f"(expected {a.tolist()[:4]}…, charged "
                        f"{b.tolist()[:4]}…)")
            break
    return errs


# ------------------------------------------------------------------------ ecc
@_traced("ecc")
def ecc_errors(runtime) -> list[str]:
    """Membrane-parity detector readout: nonzero per-image ECC hit counts
    from the last forward mean membrane words were upset mid-inference."""
    ecc = getattr(runtime, "last_ecc", None)
    if ecc is None:
        return []
    ecc = np.asarray(ecc)
    rows = np.nonzero(ecc > 0)[0]
    if not rows.size:
        return []
    return [f"ecc: membrane parity hits on {rows.size} images "
            f"(rows {rows.tolist()[:8]}, {int(ecc.sum())} upsets)"]
