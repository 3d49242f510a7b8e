"""Cross-process ``LoweredProgram`` distribution: serialize / deserialize.

The port of ``repro.core.program_io``: "lower once per *process group*". In
multi-host serving every host holds the same exported artifact on disk, so
shipping device tensors over the wire would be pure waste. The envelope
carries only what the arrays cannot reproduce — the typed scalars, the
encode/decode plans and the content fingerprints — as canonical JSON:

    {"format": 1,
     "program_fingerprint": "...", "artifact_fingerprint": "...",
     "scalars": {"T": ..., "x_min": ..., ...},
     "encode": {...}, "decode": {...},
     "arrays": {"w_float": "<sha256>", ...}}

The envelope names no device and is byte for byte the JAX package's for the
same artifact, so either package's follower reads the other's leader.
``deserialize_program`` re-maps the arrays from the *local* artifact onto
``device``, re-verifies every one against the envelope's hashes, recomputes
the program fingerprint from (artifact fingerprint, scalars) and demands it
match the envelope's — so a follower either reconstructs a program
bit-identical to the leader's lower (never calling ``_lower_uncached``) or
fails loudly with the first mismatched field named.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import torch

from repro_torch.core.artifact import Artifact, array_hash
from repro_torch.core.hw import PYNQ_COST
from repro_torch.core.lowering import (REQUIRED_ARRAYS, LoweredProgram,
                                       get_cache, program_fingerprint,
                                       program_tensors, resolve_device)
from repro_torch.core.types import DecodePlan, EncodePlan

FORMAT_VERSION = 1

#: envelope scalar order mirrors the ``scalars`` dict in ``_lower_uncached``
SCALAR_FIELDS = ("T", "x_min", "e_max", "leak_shift", "n_in", "n_out",
                 "n_groups", "per_group", "fallback", "scale", "n_pad",
                 "lane")


class ProgramIOError(ValueError):
    """The envelope does not reconstruct a valid program on this host."""


def serialize_program(prog: LoweredProgram) -> bytes:
    """Canonical JSON envelope for one lowered program (no array payload)."""
    if not isinstance(prog, LoweredProgram):
        raise TypeError(f"cannot serialize {type(prog).__name__} "
                        f"(expected LoweredProgram)")
    art = prog.artifact
    envelope = {
        "format": FORMAT_VERSION,
        "program_fingerprint": prog.fingerprint,
        "artifact_fingerprint": art.fingerprint(),
        "scalars": {f: getattr(prog, f) for f in SCALAR_FIELDS},
        "encode": dataclasses.asdict(prog.encode),
        "decode": dataclasses.asdict(prog.decode),
        "arrays": {n: array_hash(art.arrays[n]) for n in REQUIRED_ARRAYS},
    }
    return json.dumps(envelope, sort_keys=True,
                      separators=(",", ":")).encode()


def envelope_digest(blob: bytes) -> str:
    """SHA-256 hex over the raw envelope bytes — the content address the
    network transport stamps into its frame checksum and telemetry. Distinct
    from ``program_fingerprint`` (which binds scalars to the artifact): this
    digest names the exact serialized BYTES."""
    return hashlib.sha256(blob).hexdigest()


def _load_envelope(blob: bytes) -> dict:
    try:
        env = json.loads(blob)
    except (ValueError, UnicodeDecodeError) as e:
        raise ProgramIOError(f"envelope is not valid JSON: {e}") from None
    if not isinstance(env, dict):
        raise ProgramIOError(f"envelope must be a JSON object, "
                             f"got {type(env).__name__}")
    if env.get("format") != FORMAT_VERSION:
        raise ProgramIOError(f"envelope format {env.get('format')!r} != "
                             f"supported {FORMAT_VERSION}")
    for key in ("program_fingerprint", "artifact_fingerprint", "scalars",
                "encode", "decode", "arrays"):
        if key not in env:
            raise ProgramIOError(f"envelope is missing {key!r}")
    return env


def deserialize_program(blob: bytes, artifact: Artifact, *,
                        device: str | torch.device = "cuda",
                        cache: bool = True) -> LoweredProgram:
    """Reconstruct a leader's program against the local artifact copy, on
    ``device``.

    Verification order is deliberate — cheapest and most diagnostic first:
    artifact fingerprint (whole-artifact identity), the array set, each
    array's hash (names the drifted array), the scalar set, the recomputed
    program fingerprint (binds the scalars), then the plans' consistency
    with the scalars. With ``cache=True`` the program is seeded into the
    active cache under ``(artifact fingerprint, device)``, so later
    ``lower(artifact, device=device)`` / ``make_runtime`` calls on this host
    hit without ever lowering."""
    if not isinstance(artifact, Artifact):
        raise TypeError(f"cannot deserialize against "
                        f"{type(artifact).__name__} (expected Artifact)")
    dev = resolve_device(device)
    env = _load_envelope(blob)
    art_fp = artifact.fingerprint()
    if env["artifact_fingerprint"] != art_fp:
        raise ProgramIOError(
            f"local artifact fingerprint {art_fp[:12]}... != envelope's "
            f"{str(env['artifact_fingerprint'])[:12]}... — the follower's "
            f"artifact copy is not the one the leader lowered")
    if set(env["arrays"]) != set(REQUIRED_ARRAYS):
        raise ProgramIOError(
            f"envelope array set {sorted(env['arrays'])} != required "
            f"{sorted(REQUIRED_ARRAYS)}")
    for name in REQUIRED_ARRAYS:
        if name not in artifact.arrays:
            raise ProgramIOError(f"local artifact is missing array {name!r}")
        local = array_hash(artifact.arrays[name])
        if local != env["arrays"][name]:
            raise ProgramIOError(
                f"array {name!r} hash mismatch: local {local[:12]}... != "
                f"envelope {str(env['arrays'][name])[:12]}...")
    scalars = env["scalars"]
    if set(scalars) != set(SCALAR_FIELDS):
        raise ProgramIOError(
            f"envelope scalar set {sorted(scalars)} != expected "
            f"{sorted(SCALAR_FIELDS)}")
    expect_fp = program_fingerprint(art_fp, scalars)
    if expect_fp != env["program_fingerprint"]:
        raise ProgramIOError(
            f"recomputed program fingerprint {expect_fp[:12]}... != "
            f"envelope's {str(env['program_fingerprint'])[:12]}... — "
            f"scalars were altered in transit")
    try:
        encode = EncodePlan(**env["encode"])
        decode = DecodePlan(**env["decode"])
    except TypeError as e:
        raise ProgramIOError(f"envelope plan fields do not reconstruct "
                             f"encode/decode plans: {e}") from None
    # the plans are redundant with the scalars BY CONSTRUCTION (lowering
    # derives them); demand consistency so a tamperer cannot smuggle a
    # divergent plan past the fingerprint check (which binds scalars only)
    want_encode = EncodePlan(T=scalars["T"], x_min=scalars["x_min"],
                             e_max=scalars["e_max"], n_in=scalars["n_in"])
    want_decode = DecodePlan(n_groups=scalars["n_groups"],
                             per_group=scalars["per_group"],
                             sentinel=scalars["T"],
                             fallback=scalars["fallback"])
    if encode != want_encode:
        raise ProgramIOError(f"envelope encode plan {env['encode']} is "
                             f"inconsistent with its scalars — plan fields "
                             f"were altered independently")
    if decode != want_decode:
        raise ProgramIOError(f"envelope decode plan {env['decode']} is "
                             f"inconsistent with its scalars — plan fields "
                             f"were altered independently")

    prog = LoweredProgram(
        fingerprint=expect_fp, artifact=artifact, device=dev,
        T=scalars["T"], x_min=scalars["x_min"], e_max=scalars["e_max"],
        leak_shift=scalars["leak_shift"], n_in=scalars["n_in"],
        n_out=scalars["n_out"], n_groups=scalars["n_groups"],
        per_group=scalars["per_group"], fallback=scalars["fallback"],
        scale=scalars["scale"], n_pad=scalars["n_pad"],
        lane=scalars["lane"],
        **program_tensors(artifact, dev),
        encode=encode, decode=decode, cost=PYNQ_COST)
    if cache:
        prog = get_cache().seed(art_fp, dev, prog)
    return prog
