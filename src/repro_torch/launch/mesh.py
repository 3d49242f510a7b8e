"""The lower-once program broadcast hook.

The port of the broadcast half of ``repro.launch.mesh``. The mesh builders
(``build_mesh``, ``make_production_mesh``, ``make_test_mesh``) belong to
ROADMAP §1 item 11 and are not ported.

``broadcast_program`` is the process-group companion to the per-process
``ProgramCache``: the leader lowers once and publishes the serialized
envelope, every follower deserializes it against its local artifact copy
(skipping ``_lower_uncached``) and can diff program fingerprints against the
leader's. Transport is pluggable — ``file_publisher``/``file_fetcher`` cover
the shared-filesystem launch topology, ``distributed.transport`` the TCP one.
"""

from __future__ import annotations

import os
import time


# ------------------------------------------------ program broadcast hook
class ProgramBroadcastError(RuntimeError):
    """A follower could not obtain the leader's envelope (transport failure,
    timeout, retries exhausted). Typed so launch supervisors can tell a
    distribution failure from a program-integrity failure
    (``ProgramIOError``) — the two demand different remediation (retry /
    re-elect leader vs. quarantine the envelope). Carries the transport's
    original exception as ``cause``."""

    def __init__(self, role: str, cause: Exception):
        super().__init__(f"{role}: program broadcast failed: "
                         f"{type(cause).__name__}: {cause}")
        self.role = role
        self.cause = cause


def broadcast_program(artifact, *, leader, publish=None, fetch=None,
                      device="cuda"):
    """Lower once per process group, on ``device`` in every process.

    Leader: lowers the artifact (through the active program cache) and, if
    ``publish`` is given, sends the serialized envelope to the group —
    exactly one publish per leader call, no matter how many followers fetch
    it (the transport serves the same envelope to every connection).
    Follower: peeks the local program cache first — a pre-warmed follower
    (program already resident for this artifact fingerprint on ``device``,
    resolved as ``lower`` resolves it) NEVER touches
    the network; otherwise ``fetch()``es the leader's envelope and
    deserializes it against the local artifact copy, never calling the
    lowering stage. Transport failures surface as a typed
    ``ProgramBroadcastError`` (bounded fetchers raise, they do not hang);
    integrity failures keep their ``ProgramIOError`` type. Both roles return
    the resident ``LoweredProgram``; fingerprint equality across the group
    is the cross-host determinism check conformance pins in-process.
    """
    from repro_torch.core.lowering import get_cache, lower, resolve_device
    from repro_torch.core.program_io import (deserialize_program,
                                             serialize_program)
    device = resolve_device(device)
    if leader:
        prog = lower(artifact, device=device)
        if publish is not None:
            publish(serialize_program(prog))
        return prog
    if fetch is None:
        raise ValueError("follower role requires a fetch callable "
                         "(the leader's published envelope)")
    resident = get_cache().peek(artifact.fingerprint(), device)
    if resident is not None:
        return resident
    try:
        blob = fetch()
    except Exception as e:
        raise ProgramBroadcastError("follower", e) from e
    return deserialize_program(blob, artifact, device=device)


def file_publisher(path):
    """Publish an envelope to a shared-filesystem path, atomically: followers
    polling the path never observe a partial write."""
    def publish(blob: bytes) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    return publish


def file_fetcher(path, *, timeout_s: float = 30.0, poll_s: float = 0.05):
    """Fetch the leader's envelope from a shared-filesystem path, polling
    until the leader publishes or the timeout elapses."""
    def fetch() -> bytes:
        deadline = time.monotonic() + timeout_s
        while not os.path.exists(path):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no program envelope at {path!r} after {timeout_s}s — "
                    f"did the leader publish?")
            time.sleep(poll_s)
        with open(path, "rb") as f:
            return f.read()
    return fetch
