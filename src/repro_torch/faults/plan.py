"""Seeded fault plans — the deterministic description of WHAT goes wrong.

A copy of ``repro.faults.plan`` (numpy only, as there): the same fields,
grammar and seeded streams, so a plan draws the JAX package's exact fault
sequence.

A ``FaultPlan`` is an immutable, seed-driven recipe for every hardware and
host failure mode the resilience layer is built to survive. The plan itself
never touches a runtime: ``faults.models`` interprets it at three injection
sites (the artifact's BRAM-resident arrays, the board emulator's AER/neuron
datapath, the serving tier's worker lanes), and every draw is derived from
``(seed, stream, lane)`` so a fault sweep is exactly reproducible — the same
plan corrupts the same bits, drops the same events, crashes the same batch.

Fault classes (each maps to a detector in ``faults.detect``):

  static   — SEU bit flips in the int8 weight blocks / int32 thresholds of
             the deployment artifact's in-memory copy (the BRAM image).
             Applied by ``core.runtimes.make_runtime(..., faults=)`` to ANY
             runtime family via ``models.corrupt_artifact``; detected by the
             artifact's own per-array SHA-256 manifest.
  dynamic  — board-datapath faults the per-image scheduler (``board-py``)
             emulates event-by-event: membrane SEUs (with the BRAM parity /
             ECC detector modeled alongside, as on real FPGAs), stuck-at
             neuron groups, AER link drop/duplicate/reorder, and a forced
             FIFO depth (pure backpressure — semantically clean, stalls
             only). Other families reject dynamic plans loudly.
  lane     — host-side worker faults the serving scheduler injects around
             ``_Lane.serve``: crash (raises ``InjectedFault``), hang
             (sleeps past the watchdog), slowdown.

``FaultPlan.none()`` is the pinned clean plan: every runtime constructed
under it must stay bit-exact with the unfaulted build (asserted against the
golden traces in ``tests/golden/``), so the injection hooks can never fork
the clean path.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

#: membrane-SEU flips hit any of the 32 bits of an int32 membrane word
MEMBRANE_BITS = 32

#: fields a *dynamic* (board-datapath) plan may set — only ``board-py``
#: emulates these; ``make_runtime`` rejects them for every other spec
DYNAMIC_FIELDS = ("seu_membrane_rate", "stuck_groups", "aer_drop_rate",
                  "aer_dup_rate", "aer_reorder_rate", "fifo_depth")

#: fields a *static* (artifact-resident) plan may set — any runtime family
STATIC_FIELDS = ("seu_weight_flips", "seu_threshold_flips")

#: fields interpreted by the serving tier's lane injector only
LANE_FIELDS = ("crash_batches", "hang_batches", "slow_s")

#: spec-grammar aliases for ``FaultPlan.parse``
_PARSE_ALIASES = {
    "seu_weight": "seu_weight_flips", "seu_thr": "seu_threshold_flips",
    "membrane": "seu_membrane_rate", "stuck": "stuck_groups",
    "aer_drop": "aer_drop_rate", "aer_dup": "aer_dup_rate",
    "aer_reorder": "aer_reorder_rate", "fifo": "fifo_depth",
    "crash": "crash_batches", "hang": "hang_batches", "slow": "slow_s",
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded fault recipe. All-defaults == the clean plan."""

    seed: int = 0
    # ---- static: SEU bit flips in the artifact's BRAM-resident arrays ----
    seu_weight_flips: int = 0        # bits flipped across the weight blocks
    seu_threshold_flips: int = 0     # bits flipped across the threshold blocks
    # ---- dynamic: board-datapath faults (board-py emulates these) --------
    seu_membrane_rate: float = 0.0   # P(one membrane bit flips) per tick
    stuck_groups: int = 0            # hardware groups forced stuck-at
    stuck_mode: str = "saturated"    # "saturated" (fires at tick 0) | "silent"
    aer_drop_rate: float = 0.0       # P(event lost on the AER link)
    aer_dup_rate: float = 0.0        # P(event duplicated)
    aer_reorder_rate: float = 0.0    # P(event displaced across a tick edge)
    fifo_depth: int | None = None    # force the ingress FIFO depth (stalls)
    # ---- lane: host-side worker faults (serving scheduler injects) ------
    crash_batches: tuple[int, ...] = ()   # lane-local batch indices that crash
    hang_batches: tuple[int, ...] = ()    # lane-local batch indices that hang
    hang_s: float = 2.0                   # how long a hang sleeps
    slow_s: float = 0.0                   # added latency per batch
    lanes: tuple[int, ...] | None = None  # restrict faults to these lanes
    # ---- lifecycle -------------------------------------------------------
    persistent: bool = False         # re-apply on lane rebuild (unscrubable)

    # ------------------------------------------------------------- queries
    @property
    def has_static(self) -> bool:
        return any(getattr(self, f) for f in STATIC_FIELDS)

    @property
    def has_dynamic(self) -> bool:
        return any(getattr(self, f) not in (0, 0.0, None)
                   for f in DYNAMIC_FIELDS)

    @property
    def has_lane_faults(self) -> bool:
        return any(getattr(self, f) for f in LANE_FIELDS)

    @property
    def is_clean(self) -> bool:
        return not (self.has_static or self.has_dynamic
                    or self.has_lane_faults)

    @property
    def has_aer_faults(self) -> bool:
        return bool(self.aer_drop_rate or self.aer_dup_rate
                    or self.aer_reorder_rate)

    # ------------------------------------------------------------- factory
    @classmethod
    def none(cls, seed: int = 0) -> "FaultPlan":
        """The pinned clean plan — injection hooks active, zero faults."""
        return cls(seed=seed)

    @classmethod
    def coerce(cls, obj) -> "FaultPlan | None":
        """None | FaultPlan | spec string | kwargs dict -> FaultPlan | None."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, str):
            return cls.parse(obj)
        if isinstance(obj, dict):
            return cls(**obj)
        raise TypeError(f"cannot build a FaultPlan from {type(obj).__name__}")

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Spec-grammar extension: ``"seu_weight=4,aer_drop=0.02,seed=7"``.

        Keys are field names or the short aliases in ``_PARSE_ALIASES``;
        ``crash``/``hang`` take ``:``-separated batch indices (``crash=0:1``).
        An empty string parses to the clean plan."""
        kw: dict = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for part in filter(None, (p.strip() for p in text.split(","))):
            key, sep, val = part.partition("=")
            name = _PARSE_ALIASES.get(key, key)
            if name not in fields:
                raise ValueError(f"unknown fault-plan key {key!r} in {text!r}")
            if not sep:
                raise ValueError(f"fault-plan entry {part!r} needs '=value'")
            if name in ("crash_batches", "hang_batches", "lanes"):
                kw[name] = tuple(int(v) for v in val.split(":"))
            elif name in ("stuck_mode",):
                kw[name] = val
            elif name == "persistent":
                kw[name] = val.lower() in ("1", "true", "yes")
            elif name in ("seed", "seu_weight_flips", "seu_threshold_flips",
                          "stuck_groups", "fifo_depth"):
                kw[name] = int(val)
            else:
                kw[name] = float(val)
        return cls(**kw)

    # ------------------------------------------------------------ lifecycle
    def for_lane(self, lane_id: int) -> "FaultPlan":
        """The plan as one worker lane sees it: lanes outside ``lanes`` get
        the clean plan; in-scope lanes get a lane-decorrelated seed so two
        lanes never draw identical fault schedules."""
        if self.lanes is not None and lane_id not in self.lanes:
            return FaultPlan.none(seed=self.seed)
        return dataclasses.replace(self, seed=self.seed * 1000 + lane_id)

    def after_scrub(self) -> "FaultPlan":
        """The plan that survives a lane rebuild: a persistent fault
        (unscrubable — e.g. a stuck-at logic defect) re-applies; a transient
        one is gone once the BRAM image is reloaded from the golden copy."""
        return self if self.persistent else FaultPlan.none(seed=self.seed)

    # ------------------------------------------------------------- drawing
    def rng(self, *stream) -> np.random.RandomState:
        """Derived RandomState for one named injection stream — stable under
        plan-field changes that don't touch the seed, decorrelated across
        streams (hash of seed + stream path)."""
        h = hashlib.sha256(repr((self.seed,) + stream).encode()).digest()
        return np.random.RandomState(int.from_bytes(h[:4], "little"))

    def describe(self) -> str:
        active = [f"{f.name}={getattr(self, f.name)!r}"
                  for f in dataclasses.fields(self)
                  if f.name not in ("seed", "hang_s", "stuck_mode", "lanes",
                                    "persistent")
                  and getattr(self, f.name) not in (0, 0.0, None, ())]
        return (f"FaultPlan(seed={self.seed}, "
                + (", ".join(active) if active else "clean")
                + (", persistent" if self.persistent else "") + ")")
