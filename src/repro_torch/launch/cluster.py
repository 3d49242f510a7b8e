"""Cluster program distribution: the transport grammar + leader/follower glue.

The port of ``repro.launch.cluster``; every process lowers or deserializes
onto its own ``device``.

``launch.serve`` (and anything else that wants "lower once per process
group") names its transport with one string::

    tcp://HOST:PORT      network transport (distributed.transport) — the
                         multi-host leg; PORT 0 lets a leader bind an
                         ephemeral port (its handle reports the real one)
    file:///PATH | PATH  shared-filesystem transport (launch.mesh) — the
                         single-host multi-process leg

``distribute_program`` resolves the string, builds the matching
publish/fetch hooks, and runs ``broadcast_program``; the leader additionally
gets a ``LeaderHandle`` so a launch script can block until every follower
has fetched (``await_fetches``) before tearing the endpoint down — without
it, a fast leader exits and followers see connection-refused storms.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import broadcast_program, file_fetcher, file_publisher

TRANSPORT_GRAMMAR = "tcp://HOST:PORT | file:///PATH | PATH"


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """A parsed transport spec: ``scheme`` is ``"tcp"`` or ``"file"``."""

    scheme: str
    host: str = ""
    port: int = 0
    path: str = ""

    def __str__(self) -> str:
        if self.scheme == "tcp":
            return f"tcp://{self.host}:{self.port}"
        return f"file://{self.path}"


def parse_transport(spec: str) -> Endpoint:
    """Parse a transport spec per ``TRANSPORT_GRAMMAR``; bare paths are the
    file transport (backward compatible with ``--program-envelope``)."""
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"empty transport spec (expected "
                         f"{TRANSPORT_GRAMMAR})")
    spec = spec.strip()
    if spec.startswith("tcp://"):
        rest = spec[len("tcp://"):]
        host, sep, port_s = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(f"tcp transport {spec!r} must be "
                             f"tcp://HOST:PORT")
        try:
            port = int(port_s, 10)
        except ValueError:
            raise ValueError(f"tcp transport {spec!r}: port {port_s!r} is "
                             f"not an integer") from None
        if not 0 <= port <= 65535:
            raise ValueError(f"tcp transport {spec!r}: port {port} out of "
                             f"range [0, 65535]")
        return Endpoint(scheme="tcp", host=host, port=port)
    if spec.startswith("file://"):
        path = spec[len("file://"):]
        if not path:
            raise ValueError(f"file transport {spec!r} has an empty path")
        return Endpoint(scheme="file", path=path)
    if "://" in spec:
        scheme = spec.split("://", 1)[0]
        raise ValueError(f"unknown transport scheme {scheme!r} (expected "
                         f"{TRANSPORT_GRAMMAR})")
    return Endpoint(scheme="file", path=spec)


class LeaderHandle:
    """What a leader holds after publishing: the barrier + teardown surface.

    For the tcp transport it wraps the live ``ProgramServer``; for the file
    transport (the envelope persists on disk, nothing to keep alive or wait
    on) it is inert — ``await_fetches`` is immediately satisfied."""

    def __init__(self, server=None):
        self.server = server

    @property
    def endpoint(self) -> str | None:
        return self.server.endpoint if self.server is not None else None

    @property
    def serves(self) -> int:
        return self.server.serves if self.server is not None else 0

    def await_fetches(self, n: int, timeout_s: float = 30.0) -> bool:
        if self.server is None or n <= 0:
            return True
        return self.server.await_serves(n, timeout_s)

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()

    def __enter__(self) -> "LeaderHandle":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def distribute_program(artifact, spec: str, *, role: str,
                       timeout_s: float = 30.0, retries: int = 3,
                       backoff_s: float = 0.05, seed: int = 0,
                       device="cuda"):
    """Run the leader/follower program broadcast over a named transport.

    Returns ``(program, handle)``. The handle is only meaningful to the
    leader (followers get an inert one); a tcp leader should
    ``handle.await_fetches(n)`` before exiting so followers are never
    orphaned mid-fetch, then ``handle.stop()``.

    The follower's fetch is bounded end to end: the tcp fetcher splits the
    caller's ``timeout_s`` across its connect/read deadlines and retries
    with seeded-jitter backoff; the file fetcher polls until ``timeout_s``.
    Either way a distribution failure surfaces as the typed
    ``ProgramBroadcastError`` from ``broadcast_program`` — never a hang.
    """
    if role not in ("leader", "follower"):
        raise ValueError(f"role must be 'leader' or 'follower', got {role!r}")
    ep = parse_transport(spec)
    leader = role == "leader"
    if ep.scheme == "tcp":
        from repro_torch.distributed.transport import (tcp_fetcher,
                                                       tcp_publisher)
        if leader:
            publish = tcp_publisher(ep.host, ep.port)
            prog = broadcast_program(artifact, leader=True, publish=publish,
                                     device=device)
            return prog, LeaderHandle(publish.server)
        # each attempt gets an equal slice of the budget so retries fit
        per_try = max(0.05, timeout_s / (retries + 1) / 2)
        fetch = tcp_fetcher(ep.host, ep.port, connect_timeout_s=per_try,
                            read_timeout_s=per_try, retries=retries,
                            backoff_s=backoff_s, seed=seed)
        return (broadcast_program(artifact, leader=False, fetch=fetch,
                                  device=device), LeaderHandle())
    if leader:
        prog = broadcast_program(artifact, leader=True,
                                 publish=file_publisher(ep.path),
                                 device=device)
        return prog, LeaderHandle()
    fetch = file_fetcher(ep.path, timeout_s=timeout_s)
    return (broadcast_program(artifact, leader=False, fetch=fetch,
                              device=device), LeaderHandle())
