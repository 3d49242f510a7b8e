"""Deployment-artifact fuzzer — random *valid* artifacts + adversarial events.

``fuzz_case(seed)`` builds, deterministically from the seed, everything the
differential oracles need:

  * a deployment artifact with fuzzed layer widths (n_in, n_groups x
    per_group), int8 weights drawn from several distribution families,
    per-neuron int32 thresholds calibrated from simulated membrane peaks
    (plus never-fire / hair-trigger outliers), a power-of-two leak from
    ``quant.leak_shift_from_tau`` over fuzzed tau (including the inf/0
    sentinels), grouped TTFS decode metadata with both fallback rules, and
    the padded block layout from ``codesign.plan``/``blocked_layout`` —
    exactly the arrays and meta ``deploy.export`` emits, minus the training;
  * an adversarial evaluation batch expressed as IMAGES (every runtime's
    input contract): uniform-random rows plus a same-tick flood, a
    never-spike row, tie-heavy rows, a deterministic ramp, and a
    front-loaded burst. E_max is calibrated from this exact batch with
    headroom 1.0, so floods on lane-multiple n_in land on the exact-E_max
    boundary (no overflow, maximal FIFO pressure).

Images are constructed by inverting the TTFS encoder (``images_from_times``)
and the roundtrip ``encode_ttfs(images) == times`` is checked (the port's
encoder, on a CPU tensor), so the spike times the oracles reason about are
exactly the times every runtime sees.

The port of ``repro.conformance.fuzz``: numpy on the host, and for every
seed the same artifact (fingerprint), images, times and notes as the JAX
package's. ``fuzz_envelope_mutations`` gives, seed for seed, the JAX
package's mutations of a serialized program envelope, byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import codesign, events, quant, ttfs
from repro_torch.core.artifact import FORMAT_VERSION, Artifact
from repro_torch.core.hw import PYNQ_COST

#: weight distribution families the fuzzer cycles through
WEIGHT_FAMILIES = ("normal", "uniform", "sparse", "heavy", "constant", "zero")

#: board capacity: fuzzed n_out may not need more hardware groups than exist
MAX_N_OUT = PYNQ_COST.groups * PYNQ_COST.lane


@dataclasses.dataclass
class FuzzedCase:
    seed: int
    artifact: Artifact
    images: np.ndarray   # (B, n_in) float32 — adversarial evaluation batch
    times: np.ndarray    # (B, n_in) int32 — encode_ttfs(images), verified
    notes: dict          # generator decisions, for failure reports


def images_from_times(times: np.ndarray, T: int) -> np.ndarray:
    """Invert the TTFS encoder: spike times -> images.

    Valid targets are t in [0, T-2] (t = T-1 is unreachable for any
    x >= x_min > 0 because floor((1-x)(T-1)) < T-1) and t = T (never spikes,
    realized as intensity 0). Uses the midpoint intensity of each time bin,
    so the roundtrip is exact for any x_min <= 0.5/(T-1)."""
    times = np.asarray(times)
    if T < 4:
        raise ValueError(f"T={T} too small for a stable inverse (need >= 4)")
    if np.any((times > T) | (times == T - 1) | (times < 0)):
        raise ValueError("times must lie in [0, T-2] or equal T (never)")
    x = 1.0 - (times.astype(np.float64) + 0.5) / (T - 1)
    return np.where(times >= T, 0.0, x).astype(np.float32)


# --------------------------------------------------------------------- streams
def _adversarial_times(rng: np.random.RandomState, n_in: int, T: int,
                       n_random: int = 6) -> tuple[np.ndarray, list[str]]:
    """(B, n_in) spike-time rows: one of each named adversarial pattern,
    then random rows. The named patterns come FIRST so the oracles'
    ``images[:py_slice]`` prefix (the slow per-image board scheduler's
    batch) exercises them, not just the batched paths."""
    rows, names = [], []
    hi = T - 2   # latest reachable spike time

    # same-tick flood: every input spikes at once (peak FIFO occupancy; on a
    # lane-multiple n_in this IS the exact-E_max boundary after calibration)
    rows.append(np.full(n_in, rng.randint(0, hi + 1)))
    names.append("flood")

    # never-spike row: zero events end to end (decode fallback territory)
    rows.append(np.full(n_in, T))
    names.append("never")

    # tie-heavy: all events collapse onto <= 3 distinct ticks
    ticks = rng.choice(hi + 1, size=min(3, hi + 1), replace=False)
    rows.append(ticks[rng.randint(0, len(ticks), size=n_in)])
    names.append("ties")

    # deterministic ramp: every reachable tick exercised
    rows.append(np.arange(n_in) % (hi + 1))
    names.append("ramp")

    # front-loaded burst then silence
    t = rng.randint(0, max(1, min(2, hi + 1)), size=n_in)
    quiet = rng.rand(n_in) < 0.3
    rows.append(np.where(quiet, T, t))
    names.append("burst")

    for i in range(n_random):
        t = rng.randint(0, hi + 1, size=n_in)
        never = rng.rand(n_in) < rng.uniform(0.0, 0.6)
        rows.append(np.where(never, T, t))
        names.append(f"random{i}")

    return np.stack(rows).astype(np.int64), names


# --------------------------------------------------------------------- weights
def _fuzz_weights(rng: np.random.RandomState, family: str, n_in: int,
                  n_out: int) -> np.ndarray:
    shape = (n_in, n_out)
    if family == "normal":
        w = rng.randn(*shape) * rng.uniform(0.01, 2.0)
    elif family == "uniform":
        b = rng.uniform(0.05, 3.0)
        w = rng.uniform(-b, b, size=shape)
    elif family == "sparse":
        w = rng.randn(*shape) * (rng.rand(*shape) < rng.uniform(0.05, 0.4))
    elif family == "heavy":
        w = np.clip(rng.standard_cauchy(shape), -50.0, 50.0)
    elif family == "constant":
        w = np.full(shape, rng.uniform(-1.0, 1.0))
    elif family == "zero":
        w = np.zeros(shape)
    else:
        raise ValueError(f"unknown weight family {family!r}")
    return w.astype(np.float32)


def _simulate_peaks(times: np.ndarray, w_int8: np.ndarray, T: int,
                    leak_shift: int) -> np.ndarray:
    """(B, n_out) per-neuron peak membrane over the batch — a pure-numpy
    mirror of the integer LIF recurrence, used only to place thresholds."""
    B, n_in = times.shape
    raster = (times[:, None, :] == np.arange(T)[None, :, None])
    cur = raster.astype(np.int32).reshape(B * T, n_in) @ w_int8.astype(np.int32)
    cur = cur.reshape(B, T, -1)
    v = np.zeros((B, cur.shape[-1]), np.int32)
    peak = np.full_like(v, np.iinfo(np.int32).min)
    for t in range(T):
        v = v - (v >> leak_shift) + cur[:, t]
        peak = np.maximum(peak, v)
    return peak


def _fuzz_thresholds(rng: np.random.RandomState, peaks: np.ndarray,
                     n_out: int) -> np.ndarray:
    """Quantile-of-peaks placement (the shape deploy.calibrate_thresholds
    produces) with adversarial outliers mixed in."""
    q = rng.uniform(0.4, 0.95)
    scale = rng.uniform(0.3, 1.2)
    base = np.quantile(peaks, q, axis=0) * scale
    thr = np.maximum(1, base).astype(np.int64)
    # outliers: some neurons can never fire, some are hair-triggers
    never = rng.rand(n_out) < rng.uniform(0.0, 0.2)
    hair = (~never) & (rng.rand(n_out) < rng.uniform(0.0, 0.2))
    thr[never] = int(quant.INT32_NEVER_FIRE)
    thr[hair] = 1
    return np.clip(thr, 1, int(quant.INT32_NEVER_FIRE)).astype(np.int32)


# ------------------------------------------------------------------------ case
def fuzz_case(seed: int, n_random_images: int = 6) -> FuzzedCase:
    """Deterministically generate one valid (artifact, adversarial batch)."""
    rng = np.random.RandomState(seed)

    # ---- geometry -------------------------------------------------------
    n_groups = int(rng.randint(2, 13))
    per_group = int(rng.randint(1, 21))
    n_out = n_groups * per_group
    if n_out > MAX_N_OUT:          # respect the board's group capacity
        per_group = MAX_N_OUT // n_groups
        n_out = n_groups * per_group
    if rng.rand() < 0.3:
        # lane-multiple input width: floods hit the exact-E_max boundary
        n_in = int(rng.randint(1, 4)) * PYNQ_COST.lane
    else:
        n_in = int(rng.randint(8, 385))
    T = int(rng.randint(4, 34))
    x_min = float(rng.choice([1.0 / 255.0, 0.01]))
    assert x_min <= 0.5 / (T - 1), "inverse-encode validity"

    # ---- dynamics -------------------------------------------------------
    tau = float(rng.choice([
        rng.uniform(0.5, 4.0), rng.uniform(4.0, 64.0),
        rng.uniform(64.0, 1e3), 1e7, np.inf, 0.0]))
    leak_shift = quant.leak_shift_from_tau(tau)
    fallback = str(rng.choice(["membrane", "zero"]))

    # ---- weights + quantization ----------------------------------------
    family = WEIGHT_FAMILIES[int(rng.randint(len(WEIGHT_FAMILIES)))]
    w_f32 = _fuzz_weights(rng, family, n_in, n_out)
    w_int8, scale = quant.quantize_weights(w_f32)

    # ---- adversarial evaluation batch ----------------------------------
    times, patterns = _adversarial_times(rng, n_in, T, n_random_images)
    images = images_from_times(times, T)
    enc = ttfs.encode_ttfs(torch.from_numpy(images), T, x_min).numpy()
    if not np.array_equal(enc, times):
        raise AssertionError(
            f"seed {seed}: TTFS inverse-encode roundtrip broke "
            f"(T={T}, x_min={x_min}) — fuzzer bug, not a runtime bug")
    times = enc.astype(np.int64)

    # ---- thresholds from simulated peaks --------------------------------
    peaks = _simulate_peaks(times, w_int8, T, leak_shift)
    thr = _fuzz_thresholds(rng, peaks, n_out)

    # ---- E_max calibrated from this exact batch (headroom 1.0) ----------
    e_max = events.calibrate_e_max(times, T, headroom=1.0)

    # ---- plan + padded block layout (the connectivity descriptor) -------
    report = codesign.plan(n_in, n_out)
    gids = ttfs.group_map(n_groups, per_group)
    layout = codesign.blocked_layout(w_int8, thr, gids, report.lane)

    meta = {
        "format_version": FORMAT_VERSION,
        "model": {"topology": "linear-ttfs", "n_in": n_in, "n_out": n_out},
        "encode": {"T": T, "x_min": x_min},
        "lif": {"leak_shift": leak_shift, "v_init": 0},
        "readout": {"n_groups": n_groups, "per_group": per_group,
                    "fallback": fallback},
        "quant": {"scale": scale, "bits": 8, "scheme": "symmetric-per-tensor"},
        "events": {"e_max": e_max, "pad": events.PAD},
        "codesign": {"lane": report.lane, "n_pad": report.n_pad,
                     "n_blocks": report.n_blocks,
                     "vmem_util": report.vmem_util,
                     "limiter": report.limiter},
        "conformance": {"seed": seed, "weight_family": family, "tau": repr(tau),
                        "patterns": patterns},
    }
    arrays = {"w_float": w_f32, "w_int8": w_int8, "thresholds": thr,
              "group_ids": gids, **layout}
    art = Artifact(meta, arrays)
    peak = int(max(np.bincount(row[row < T], minlength=T).max()
                   for row in times))
    notes = {"seed": seed, "n_in": n_in, "n_out": n_out, "n_groups": n_groups,
             "per_group": per_group, "T": T, "x_min": x_min, "tau": tau,
             "leak_shift": leak_shift, "fallback": fallback,
             "weight_family": family, "e_max": e_max, "patterns": patterns,
             "e_max_boundary_hit": bool(peak == e_max)}
    return FuzzedCase(seed=seed, artifact=art, images=images,
                      times=times.astype(np.int32), notes=notes)


def fuzz_envelope_mutations(blob: bytes, seed: int = 0) -> list[tuple[str, bytes]]:
    """Adversarial mutations of a serialized program envelope.

    Deterministically from the seed, produce (description, tampered_blob)
    variants that ``deserialize_program`` must reject: altered scalars
    (breaks the recomputed program fingerprint), a flipped array hash
    (breaks re-verification against the local artifact), a dropped required
    key, a wrong format version, and raw byte truncation. Every variant
    parses differently from the original, so an accept is a real hole, not
    a no-op mutation."""
    import json as _json

    rng = np.random.RandomState(seed)
    env = _json.loads(blob)

    def dump(e) -> bytes:
        return _json.dumps(e, sort_keys=True, separators=(",", ":")).encode()

    out: list[tuple[str, bytes]] = []
    scalar = rng.choice(sorted(env["scalars"]))
    e = _json.loads(blob)
    v = e["scalars"][scalar]
    e["scalars"][scalar] = (v + 1) if isinstance(v, (int, float)) else v + "x"
    out.append((f"scalar {scalar} altered", dump(e)))
    arr = rng.choice(sorted(env["arrays"]))
    e = _json.loads(blob)
    digest = e["arrays"][arr]
    e["arrays"][arr] = ("0" if digest[0] != "0" else "1") + digest[1:]
    out.append((f"array hash {arr} flipped", dump(e)))
    key = rng.choice(("program_fingerprint", "artifact_fingerprint",
                      "scalars", "arrays"))
    e = _json.loads(blob)
    del e[key]
    out.append((f"key {key} dropped", dump(e)))
    e = _json.loads(blob)
    e["format"] = int(e["format"]) + 1
    out.append(("format bumped", dump(e)))
    out.append(("truncated", blob[:len(blob) // 2]))
    return out
