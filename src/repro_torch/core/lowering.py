"""The one lowering stage: ``Artifact → LoweredProgram`` on one device.

The port of ``repro.core.lowering``. ``lower(artifact, device=...)``
validates and coerces the meta ONCE into a frozen, fingerprinted
``LoweredProgram`` whose arrays are tensors on ``device``; every runtime
consumes the program instead of re-reading ``artifact.m(...)``.

The program fingerprint hashes the artifact fingerprint and the typed
scalars exactly as the JAX package does, so it does not depend on the device
and equals ``repro``'s for the same artifact. The cache key adds the device:
one artifact lowered for the CPU and for the card is two cache entries with
one fingerprint.

Two cache tiers hang off the lowering stage, keyed by content:

  * program tier — ``(artifact fingerprint, device) → LoweredProgram``, a
    byte-budget LRU charged with the tensor bytes each program pins
    (``program_nbytes``); a hit refreshes recency, inserts past
    ``max_bytes`` evict from the cold end. ``seed`` installs a program that
    came over a transport and ``peek`` looks one up without lowering, both
    under the resolved device, the key ``lower`` uses.
  * bundle tier — ``(family, program fingerprint, device, …) → prepared
    tensors`` (the float32 weight copies the integer GEMM runs on). Bundles
    die with their program; bundles over programs that were never cached
    are charged to the same budget as one **orphan** entry per program.

``install()`` swaps in a scoped cache; ``get_cache()`` resolves the one in
effect.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.artifact import Artifact
from repro_torch.core.hw import PYNQ_COST, BoardCostModel
from repro_torch.core.types import DecodePlan, EncodePlan


class LoweringError(ValueError):
    """The artifact's metadata or arrays do not lower to a valid program."""


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: nothing falls back to the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_MISSING = object()


def _meta(art: Artifact, path: tuple[str, ...], kind: str):
    """One coercion point for every execution parameter: missing paths and
    junk values fail HERE, at lowering time, with the meta path named."""
    val = art.m(*path, default=_MISSING)
    name = ".".join(path)
    if val is _MISSING:
        raise LoweringError(f"artifact meta missing {name!r}")
    if kind == "int":
        if isinstance(val, bool):
            raise LoweringError(f"meta {name!r}={val!r} does not lower to int")
        if isinstance(val, (int, np.integer)):
            return int(val)
        if isinstance(val, (float, np.floating)):
            if float(val).is_integer():
                return int(val)
            raise LoweringError(f"meta {name!r}={val!r} does not lower to int")
        if isinstance(val, str):
            try:
                return int(val, 10)
            except ValueError:
                raise LoweringError(f"meta {name!r}={val!r} does not lower "
                                    f"to int") from None
        raise LoweringError(f"meta {name!r}={val!r} does not lower to int")
    if kind == "float":
        if isinstance(val, bool):
            raise LoweringError(f"meta {name!r}={val!r} does not lower to "
                                f"float")
        try:
            out = float(val)
        except (TypeError, ValueError):
            raise LoweringError(f"meta {name!r}={val!r} does not lower to "
                                f"float") from None
        if not np.isfinite(out):
            raise LoweringError(f"meta {name!r}={val!r} is not finite")
        return out
    if kind == "str":
        if not isinstance(val, str):
            raise LoweringError(f"meta {name!r}={val!r} does not lower to str")
        return val
    raise AssertionError(kind)


@dataclasses.dataclass(frozen=True, eq=False)
class LoweredProgram:
    """Frozen execution view of one deployment artifact on one device.

    ``artifact`` is the host-side back-reference the integrity detectors
    re-hash; runtimes keep ``self.art = program.artifact``."""

    fingerprint: str          # program identity (device-independent)
    artifact: Artifact
    device: torch.device
    # ---- typed scalars ----
    T: int
    x_min: float
    e_max: int
    leak_shift: int
    n_in: int
    n_out: int
    n_groups: int
    per_group: int
    fallback: str
    scale: float              # quantization scale (dense int8 baseline)
    n_pad: int                # padded output width (lane-aligned)
    lane: int                 # blocked-layout lane width from the planner
    # ---- tensors on ``device`` ----
    w_float: torch.Tensor     # (N_in, N_out) float32
    w_int8: torch.Tensor      # (N_in, N_out) int8
    thresholds: torch.Tensor  # (N_out,) int32
    w_padded: torch.Tensor    # (N_in, N_pad) int8 — blocked layout
    thr_padded: torch.Tensor  # (N_pad,) int32
    # ---- stage plans + cost binding ----
    encode: EncodePlan
    decode: DecodePlan
    cost: BoardCostModel

    @property
    def cache_key(self) -> tuple[str, str]:
        """(program fingerprint, device): what bundle keys carry at 1:3."""
        return self.fingerprint, str(self.device)


def program_fingerprint(art_fp: str, scalars: dict[str, Any]) -> str:
    h = hashlib.sha256()
    h.update(art_fp.encode())
    h.update(json.dumps(scalars, sort_keys=True).encode())
    return h.hexdigest()


#: each program tensor, and its dtype on the device
ARRAY_DTYPES = {"w_float": torch.float32, "w_int8": torch.int8,
                "thresholds": torch.int32, "w_padded": torch.int8,
                "thr_padded": torch.int32}
REQUIRED_ARRAYS = tuple(ARRAY_DTYPES)

#: the plain integer GEMM runs as float32 products of the {0,1} raster and
#: the int8 weights over slices of at most this many inputs: every partial
#: sum of a slice is an integer of magnitude at most 127 * rows, exact in
#: float32 while that stays below 2**24 (``core.reference.spike_currents``)
MAX_EXACT_N_IN = (2 ** 24 - 1) // 127


def program_tensors(art: Artifact, device: torch.device
                    ) -> dict[str, torch.Tensor]:
    """The program's tensors, copied from the artifact onto ``device`` in
    their ``ARRAY_DTYPES`` (the lowering's and the deserializer's one
    placement)."""
    return {name: torch.from_numpy(np.ascontiguousarray(art[name]).copy())
            .to(device=device, dtype=dtype)
            for name, dtype in ARRAY_DTYPES.items()}


def _lower_uncached(art: Artifact, device: torch.device) -> LoweredProgram:
    missing = [n for n in REQUIRED_ARRAYS if n not in art.arrays]
    if missing:
        raise LoweringError(f"artifact is missing arrays {missing}")
    T = _meta(art, ("encode", "T"), "int")
    if T <= 0:
        raise LoweringError(f"encode.T={T} must be positive")
    x_min = _meta(art, ("encode", "x_min"), "float")
    e_max = _meta(art, ("events", "e_max"), "int")
    leak_shift = _meta(art, ("lif", "leak_shift"), "int")
    n_in = _meta(art, ("model", "n_in"), "int")
    n_out = _meta(art, ("model", "n_out"), "int")
    n_groups = _meta(art, ("readout", "n_groups"), "int")
    per_group = _meta(art, ("readout", "per_group"), "int")
    fallback = _meta(art, ("readout", "fallback"), "str")
    scale = _meta(art, ("quant", "scale"), "float")
    lane = _meta(art, ("codesign", "lane"), "int")
    if e_max <= 0:
        raise LoweringError(f"events.e_max={e_max} must be positive")
    if per_group <= 0:
        raise LoweringError(f"readout.per_group={per_group} must be positive")
    if lane <= 0:
        raise LoweringError(f"codesign.lane={lane} must be positive")
    if scale <= 0:
        raise LoweringError(f"quant.scale={scale} must be positive")
    if not 0 <= leak_shift <= 31:
        raise LoweringError(f"lif.leak_shift={leak_shift} is not an int32 "
                            f"shift (0..31)")
    if fallback not in ("membrane", "zero"):
        raise LoweringError(f"readout.fallback={fallback!r} is not a known "
                            f"no-spike policy ('membrane' | 'zero')")
    if n_groups * per_group != n_out:
        raise LoweringError(
            f"readout geometry n_groups*per_group = {n_groups}*{per_group} "
            f"!= model.n_out = {n_out}")
    n_pad = int(art["thr_padded"].shape[0])
    if art["w_padded"].shape != (n_in, n_pad):
        raise LoweringError(
            f"w_padded shape {art['w_padded'].shape} != "
            f"(n_in={n_in}, n_pad={n_pad})")
    if art["w_int8"].shape != (n_in, n_out):
        raise LoweringError(
            f"w_int8 shape {art['w_int8'].shape} != "
            f"(n_in={n_in}, n_out={n_out})")
    if n_pad < n_out:
        raise LoweringError(f"padded width {n_pad} < n_out {n_out}")
    scalars = {"T": T, "x_min": x_min, "e_max": e_max,
               "leak_shift": leak_shift, "n_in": n_in, "n_out": n_out,
               "n_groups": n_groups, "per_group": per_group,
               "fallback": fallback, "scale": scale, "n_pad": n_pad,
               "lane": lane}

    return LoweredProgram(
        fingerprint=program_fingerprint(art.fingerprint(), scalars),
        artifact=art, device=device,
        T=T, x_min=x_min, e_max=e_max, leak_shift=leak_shift,
        n_in=n_in, n_out=n_out, n_groups=n_groups, per_group=per_group,
        fallback=fallback, scale=scale, n_pad=n_pad, lane=lane,
        **program_tensors(art, device),
        encode=EncodePlan(T=T, x_min=x_min, e_max=e_max, n_in=n_in),
        decode=DecodePlan(n_groups=n_groups, per_group=per_group,
                          sentinel=T, fallback=fallback),
        cost=PYNQ_COST)


def program_nbytes(prog: LoweredProgram) -> int:
    """Bytes a resident program pins: the sum over its device tensors."""
    return sum(getattr(prog, name).numel() * getattr(prog, name).element_size()
               for name in REQUIRED_ARRAYS)


#: default byte budget for the program tier
DEFAULT_MAX_BYTES = 1 << 30


class ProgramCache:
    """Content-addressed caches for lowered programs and their bundles.

    Program keys are ``(artifact fingerprint, device)``; bundle keys are
    ``(family, program fingerprint, device, …)``, so ``key[1:3]`` names the
    program a bundle was built over. The program tier is a byte-budget LRU
    (``max_bytes``, ``None`` = unbounded); evicting a program drops its
    bundles. Bundles built over programs that were never cached are charged
    as one orphan entry per program, refreshed on bundle hits, evicted (with
    their bundles) before any resident program, and folded into the
    resident charge if the program is installed later."""

    def __init__(self, max_bytes: int | None = DEFAULT_MAX_BYTES):
        self._lock = threading.Lock()
        self._programs: OrderedDict[tuple, LoweredProgram] = OrderedDict()
        self._bundles: dict[tuple, Any] = {}
        #: program cache_key → charged bytes, for bundle-only residents
        self._orphans: OrderedDict[tuple, int] = OrderedDict()
        self.max_bytes = max_bytes
        self.bytes = 0
        self.evictions = 0
        self.program_hits = 0
        self.program_misses = 0
        self.bundle_hits = 0
        self.bundle_misses = 0

    # -- internal (lock held) -------------------------------------------
    def _install_locked(self, key: tuple, prog: LoweredProgram
                        ) -> tuple[LoweredProgram, bool]:
        existing = self._programs.get(key)
        if existing is not None:
            self._programs.move_to_end(key)
            return existing, False
        orphaned = self._orphans.pop(prog.cache_key, None)
        if orphaned is not None:
            self.bytes -= orphaned
        self._programs[key] = prog
        self.bytes += program_nbytes(prog)
        self._evict_locked()
        return prog, True

    def _drop_bundles_locked(self, prog_key: tuple) -> None:
        for k in [k for k in self._bundles if tuple(k[1:3]) == prog_key]:
            del self._bundles[k]

    def _evict_locked(self) -> None:
        if self.max_bytes is None:
            return
        while self.bytes > self.max_bytes and self._orphans:
            pkey, nbytes = self._orphans.popitem(last=False)
            self.bytes -= nbytes
            self.evictions += 1
            self._drop_bundles_locked(pkey)
        while self.bytes > self.max_bytes and len(self._programs) > 1:
            victim_key, victim = next(iter(self._programs.items()))
            del self._programs[victim_key]
            self.bytes -= program_nbytes(victim)
            self.evictions += 1
            self._drop_bundles_locked(victim.cache_key)

    # -- program tier ---------------------------------------------------
    def program(self, art: Artifact, device: torch.device
                ) -> tuple[LoweredProgram, bool]:
        key = (art.fingerprint(), str(device))
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self.program_hits += 1
                return prog, True
        prog = _lower_uncached(art, device)
        with self._lock:
            # first lowering wins; only the installing thread counts a miss
            cached, installed = self._install_locked(key, prog)
            if installed:
                self.program_misses += 1
            else:
                self.program_hits += 1
        return cached, not installed

    def seed(self, art_fp: str, device: str | torch.device,
             prog: LoweredProgram) -> LoweredProgram:
        """Install an externally derived program (the ``deserialize`` path)
        under ``(art_fp, device)``, the key ``lower`` looks up: the device is
        resolved first (``"cuda"`` is keyed as ``"cuda:0"``). First installer
        wins, as with a racing lower; returns the resident program."""
        dev = resolve_device(device)
        if prog.device != dev:
            raise ValueError(f"cannot seed a program on {prog.device} under "
                             f"device {dev}")
        with self._lock:
            cached, _ = self._install_locked((art_fp, str(dev)), prog)
            return cached

    def peek(self, art_fp: str, device: str | torch.device
             ) -> LoweredProgram | None:
        """The resident program for ``(art_fp, device)``, or ``None`` — NEVER
        lowers. The broadcast follower's pre-warm check: a follower whose
        cache already holds the program must not touch the transport. A
        resident peek counts as a hit and refreshes recency."""
        key = (art_fp, str(resolve_device(device)))
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self.program_hits += 1
            return prog

    # -- bundle tier ----------------------------------------------------
    def bundle(self, key: tuple, build: Callable[[], Any],
               nbytes: int = 0) -> tuple[Any, bool]:
        """Get-or-build a bundle. ``key[1:3]`` is the program's
        ``cache_key``; ``nbytes`` (``program_nbytes``) is charged as an
        orphan when that program is not cache-resident."""
        pkey = tuple(key[1:3])
        with self._lock:
            if key in self._bundles:
                self.bundle_hits += 1
                if pkey in self._orphans:
                    self._orphans.move_to_end(pkey)
                return self._bundles[key], True
        built = build()
        with self._lock:
            if key in self._bundles:
                self.bundle_hits += 1
                return self._bundles[key], True
            self._bundles[key] = built
            self.bundle_misses += 1
            if (nbytes > 0 and pkey not in self._orphans
                    and not any(p.cache_key == pkey
                                for p in self._programs.values())):
                self._orphans[pkey] = int(nbytes)
                self.bytes += int(nbytes)
                self._evict_locked()
        return built, False

    def stats(self) -> dict:
        with self._lock:
            return {"programs": len(self._programs),
                    "bundles": len(self._bundles),
                    "bytes": self.bytes,
                    "max_bytes": self.max_bytes,
                    "evictions": self.evictions,
                    "program_hits": self.program_hits,
                    "program_misses": self.program_misses,
                    "bundle_hits": self.bundle_hits,
                    "bundle_misses": self.bundle_misses,
                    "orphan_programs": len(self._orphans),
                    "orphan_bundle_bytes": sum(self._orphans.values())}


#: the process-wide default cache every runtime and serving lane shares
PROGRAM_CACHE = ProgramCache()

_cache: ProgramCache = PROGRAM_CACHE


def get_cache() -> ProgramCache:
    """The cache in effect (the swap scope's, else ``PROGRAM_CACHE``)."""
    return _cache


def install(cache: ProgramCache | None) -> ProgramCache:
    """Swap the active program cache, returning the previous one;
    ``install(None)`` restores the process-wide default."""
    global _cache
    prev = _cache
    _cache = PROGRAM_CACHE if cache is None else cache
    return prev


def lower(artifact: Artifact | LoweredProgram, *,
          device: str | torch.device = "cuda",
          cache: bool = True) -> LoweredProgram:
    """Lower an artifact to its frozen execution program on ``device``.

    A program already on ``device`` passes through unchanged; one on another
    device is lowered again from its artifact. ``cache=False`` forces a
    fresh lowering that bypasses the program tier."""
    dev = resolve_device(device)
    if isinstance(artifact, LoweredProgram):
        if artifact.device == dev:
            return artifact
        artifact = artifact.artifact
    if not isinstance(artifact, Artifact):
        raise TypeError(f"cannot lower {type(artifact).__name__} "
                        f"(expected Artifact or LoweredProgram)")
    if cache:
        prog, _ = get_cache().program(artifact, dev)
        return prog
    return _lower_uncached(artifact, dev)


def lower_with_faults(artifact: Artifact | LoweredProgram, plan, *,
                      device: str | torch.device = "cuda") -> LoweredProgram:
    """The static-fault lowering pass: corrupt an in-memory CLONE of the
    artifact per the plan's seeded SEU fields (host numpy, as in the JAX
    package), then lower the clone on ``device``. The pristine artifact and
    its cached program are untouched; the corrupted program gets its own
    content fingerprint, so its ``(fingerprint, device)`` key never aliases
    the pristine one. The device is resolved as ``lower`` resolves it, and
    the clone's device tensors are copied from its corrupted host arrays
    (``program_tensors``), the arrays the checksum detector re-hashes."""
    from repro_torch.faults.models import corrupt_artifact
    art = artifact.artifact if isinstance(artifact, LoweredProgram) \
        else artifact
    return lower(corrupt_artifact(art, plan), device=device)
