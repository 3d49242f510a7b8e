"""Mesh construction and the lower-once program broadcast hook: the port of
``repro.launch.mesh``.

The mesh builders are FUNCTIONS, not module-level constants: importing this
module touches no process group and no card.

    single-pod:  (16, 16)      axes ("data", "model")       = 256 ranks
    multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 ranks

The "pod" axis is pure data parallelism across pods; "data" is data
parallel / FSDP within a pod; "model" is tensor/expert parallel. A mesh is
a ``torch.distributed`` ``DeviceMesh`` over the default process group,
whose world size must be the mesh's size: the caller initialises it (NCCL
on the cards; gloo, or the fake process group of
``torch.testing._internal.distributed.fake_pg``, on the CPU).
``distributed.sharding.mesh_of`` reads its names and sizes.

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

import torch


def build_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group, on ``device_type``: ``"cuda"`` (the default)
    raises without a card, ``"cpu"`` runs on gloo or the fake group."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type 'cuda' requested but CUDA is not available; pass "
            "device_type='cpu' to build the mesh over a CPU process group")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, device_type=device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cuda"):
    """Small mesh for unit tests (a process group of prod(shape) ranks)."""
    return build_mesh(shape, axes, device_type=device_type)


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
