"""Fault injectors — ``FaultPlan`` interpreted at its three injection sites.

The port of ``repro.faults.models``. The fault models stay host numpy, as
there: they corrupt the artifact's host arrays (the lowering copies the
corrupted arrays to the device) and the board emulator's host state, so
every seeded draw lands on the same bit as in the JAX package.

Every injector is deterministic given the plan's seed and wraps an EXISTING
hook without forking the clean path:

  * ``corrupt_artifact``      — SEU bit flips in the deployment artifact's
    in-memory arrays (the BRAM image the runtime loads). The per-array
    SHA-256 manifest is deliberately left untouched, so the artifact's own
    integrity check (``Artifact.verify``) is the detector.
  * ``FaultyAEREventQueue``   — AER link glitches (drop / duplicate /
    displace-across-a-tick) and a forced FIFO depth, built ON the clean
    ``AEREventQueue`` schedule; the board runtime records the per-tick
    dispatch histogram either way, which is what the trace detector checks.
  * ``MembraneUpsetInjector`` — SEUs in the membrane BRAM during the tick
    loop, with the parity/ECC detector modeled alongside (single-bit upsets
    are detectable by parity on real FPGAs; the emulator models both the
    upset and the detection, surfaced as per-image ECC hit counts).
  * ``apply_stuck``           — stuck-at neuron groups (a logic defect, NOT
    a memory flip: checksums cannot see it — the canary probes can).
  * ``LaneFaultInjector``     — host-side worker faults around
    ``_Lane.serve``: crash (``InjectedFault``), hang, slowdown.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.board.event_queue import AEREventQueue
from repro_torch.board.neuron_core import GroupedNeuronCore
from repro_torch.core.artifact import Artifact, array_hash
from repro_torch.core.quant import INT32_NEVER_FIRE
from repro_torch.faults.plan import MEMBRANE_BITS, FaultPlan


class InjectedFault(RuntimeError):
    """A deliberately injected host-side fault (lane crash)."""


#: artifact arrays the static SEU model can hit, by fault class — the int8
#: weight blocks and the int32 threshold blocks every runtime family loads
WEIGHT_ARRAYS = ("w_padded", "w_int8")
THRESHOLD_ARRAYS = ("thr_padded", "thresholds")


def _flip_bits(arrays: dict[str, np.ndarray], names: tuple[str, ...],
               n_flips: int, rng: np.random.RandomState) -> list[tuple]:
    """Flip ``n_flips`` uniformly random bits across the named arrays
    (in place on the dict's — already copied — entries)."""
    present = [n for n in names if n in arrays and arrays[n].size]
    flips: list[tuple] = []
    for _ in range(n_flips):
        name = present[rng.randint(len(present))]
        a = arrays[name]
        idx = int(rng.randint(a.size))
        bit = int(rng.randint(8 * a.dtype.itemsize))
        flat = a.reshape(-1)
        word = int(flat[idx]) ^ (1 << bit)
        # wrap back into the signed dtype's range (an SEU flips the stored
        # bit pattern; two's complement reinterprets it)
        span = 1 << (8 * a.dtype.itemsize)
        if word >= span // 2:
            word -= span
        elif word < -span // 2:
            word += span
        flat[idx] = word
        flips.append((name, idx, bit))
    return flips


def corrupt_artifact(art: Artifact, plan: FaultPlan) -> Artifact:
    """SEU-corrupted in-memory clone of the artifact: seeded bit flips in the
    weight / threshold blocks, manifest and fingerprint left as exported —
    so ``Artifact.verify`` (the checksum detector) fails loudly on it while
    the original stays pristine for the scrub/reload recovery path."""
    if not plan.has_static:
        return art
    meta = dict(art.meta)
    if not meta.get("manifest"):
        # an in-memory artifact that was never exported: stamp the manifest
        # and fingerprint from the PRISTINE arrays first (exactly what
        # ``Artifact.save`` would have recorded), so the SEU is detectable
        meta["manifest"] = {k: array_hash(v) for k, v in art.arrays.items()}
        meta["fingerprint"] = Artifact(meta, art.arrays).fingerprint()
    arrays = dict(art.arrays)
    for names, n, stream in ((WEIGHT_ARRAYS, plan.seu_weight_flips, "seu-w"),
                             (THRESHOLD_ARRAYS, plan.seu_threshold_flips,
                              "seu-thr")):
        if n:
            for name in names:
                if name in arrays:
                    arrays[name] = arrays[name].copy()
            _flip_bits(arrays, names, n, plan.rng(stream))
    return Artifact(meta, arrays)


class FaultyAEREventQueue(AEREventQueue):
    """The AER ingress behind a glitching link: events may be dropped,
    duplicated, or displaced across one tick boundary — deterministically
    from ``(plan.seed, image_key)``. The perturbed schedule preserves the
    iteration contract (``events_at``/``counts``/``stalls_at``), so the
    board loop is unchanged; only WHAT arrives differs."""

    def __init__(self, times: np.ndarray, T: int, depth: int,
                 plan: FaultPlan, image_key: int = 0):
        super().__init__(times, T, depth)
        rng = plan.rng("aer", int(image_key))
        self.injected_drops = self.injected_dups = self.injected_moves = 0
        buckets: list[list[int]] = [[] for _ in range(T)]
        for t in range(T):
            for nid in super().events_at(t):
                if plan.aer_drop_rate and rng.rand() < plan.aer_drop_rate:
                    self.injected_drops += 1
                    continue
                tt = t
                if (plan.aer_reorder_rate
                        and rng.rand() < plan.aer_reorder_rate):
                    tt = min(T - 1, max(0, t + (1 if rng.rand() < 0.5
                                                else -1)))
                    if tt != t:
                        self.injected_moves += 1
                buckets[tt].append(int(nid))
                if plan.aer_dup_rate and rng.rand() < plan.aer_dup_rate:
                    buckets[tt].append(int(nid))
                    self.injected_dups += 1
        self._buckets = [np.asarray(sorted(b), np.int32) for b in buckets]
        self.total_events = int(sum(len(b) for b in self._buckets))

    def events_at(self, t: int) -> np.ndarray:
        return self._buckets[t]


class MembraneUpsetInjector:
    """Per-image membrane-BRAM SEU source plus its parity detector: after
    each tick, with probability ``seu_membrane_rate``, one bit of one
    neuron's int32 membrane flips — and the modeled ECC logic records the
    hit (``ecc_hits``), which the serving tier turns into a re-serve."""

    def __init__(self, plan: FaultPlan, image_key: int = 0):
        self.rate = float(plan.seu_membrane_rate)
        self._rng = plan.rng("membrane", int(image_key))
        self.ecc_hits = 0

    def after_tick(self, core: GroupedNeuronCore, t: int) -> None:
        if not self.rate or self._rng.rand() >= self.rate:
            return
        g = int(self._rng.randint(core.groups_used))
        li = int(self._rng.randint(core.lane))
        bit = int(self._rng.randint(MEMBRANE_BITS))
        word = int(core.v[g, li]) ^ (1 << bit)
        if word >= 2 ** 31:
            word -= 2 ** 32
        elif word < -2 ** 31:
            # bit 31 of a negative membrane: the JAX package wraps only the
            # other way and numpy 2 refuses the word, so the run raises
            # there as JAX's does (numpy 1 would wrap it silently)
            raise OverflowError(f"Python integer {word} out of bounds for "
                                "int32")
        core.v[g, li] = np.int32(word)
        self.ecc_hits += 1


def apply_stuck(core: GroupedNeuronCore, plan: FaultPlan,
                n_out: int | None = None) -> list[int]:
    """Force ``plan.stuck_groups`` hardware groups stuck-at: ``saturated``
    (threshold pinned to INT32_MIN — fires at tick 0 unconditionally) or
    ``silent`` (threshold pinned to never-fire). When ``n_out`` is given the
    afflicted groups are drawn from those carrying output neurons (a stuck
    group past the readout is architecturally harmless). Returns the
    afflicted group indices. A logic fault, not a memory flip: invisible to
    the checksum detector by design; the canary probes catch it."""
    if not plan.stuck_groups:
        return []
    if plan.stuck_mode not in ("silent", "saturated"):
        raise ValueError(f"unknown stuck_mode {plan.stuck_mode!r} "
                         "(use 'saturated' or 'silent')")
    rng = plan.rng("stuck")
    span = core.groups_used
    if n_out is not None:
        span = min(span, -(-int(n_out) // core.lane))
    k = min(int(plan.stuck_groups), span)
    groups = sorted(int(g) for g in rng.choice(span, size=k, replace=False))
    val = (np.int32(INT32_NEVER_FIRE) if plan.stuck_mode == "silent"
           else np.int32(np.iinfo(np.int32).min))
    for g in groups:
        core.thr[g, :] = val
    return groups


class LaneFaultInjector:
    """Host-side worker faults, keyed by the lane-local batch index: crash
    (raise before serving), hang (sleep past any sane watchdog), slowdown
    (fixed added latency). ``disarm()`` is the circuit breaker's hook — a
    degraded lane bypasses the faulted datapath, injector included."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.batches = 0
        self.crashes = self.hangs = self.slowdowns = 0

    def before_batch(self) -> None:
        i = self.batches
        self.batches += 1
        p = self.plan
        if p.slow_s:
            self.slowdowns += 1
            time.sleep(p.slow_s)
        if i in p.hang_batches:
            self.hangs += 1
            time.sleep(p.hang_s)
        if i in p.crash_batches:
            self.crashes += 1
            raise InjectedFault(f"injected lane crash at batch {i} "
                                f"(plan seed {p.seed})")

    def disarm(self) -> None:
        self.plan = FaultPlan.none(seed=self.plan.seed)
