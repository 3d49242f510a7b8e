"""TCP program-distribution transport — the network leg of ``broadcast_program``.

The port of ``repro.distributed.transport``, on the same wire: a JAX
package's ``ProgramServer`` feeds this fetcher and this ``ProgramServer``
feeds the JAX package's fetcher. The shared-file transport in
``launch.mesh`` covers single-host multi-process serving; this module is the multi-host leg the ROADMAP called for: the leader
serves the canonical-JSON program envelope (``core.program_io``) over a
length-prefixed socket protocol, followers fetch it with bounded retries and
re-verify every fingerprint through ``deserialize_program`` before the
program may enter the local ``ProgramCache``.

Wire frame (one per connection, leader → follower, then close)::

    MAGIC(4) | VERSION(1) | LENGTH(8, big-endian) | SHA256(payload)(32) | payload

Design rules, each load-bearing for the conformance suite's
*detected-or-bit-exact* invariant:

  * every frame carries its own checksum — a flipped byte anywhere in the
    payload fails loudly naming the checksum, never reconstructs a program;
  * the checksum authenticates the FRAME, not the program: a tamperer who
    re-frames a modified envelope with a fresh checksum still fails inside
    ``deserialize_program`` (artifact/array/program fingerprints) — transport
    integrity and program integrity are independent layers, and the fault
    proxy exercises both;
  * fetches are bounded: connect and read timeouts, ``retries`` re-attempts
    with exponential backoff whose jitter comes from a SEEDED rng
    (``backoff_schedule`` is reproducible — chaos tests replay exact retry
    timing), and a hard envelope byte cap so a lying length field cannot
    balloon memory;
  * every failure is a typed ``TransportError`` subclass whose message names
    the corruption (truncation point, bad magic, checksum mismatch, timeout
    site) — a fetch NEVER returns bytes it could not verify.

Telemetry follows the tracing conventions: ``transport.publish`` /
``transport.fetch`` spans carry logical counters (bytes, attempts, retries)
in canonical ``attrs`` and host specifics (endpoint) in non-canonical
``meta``; the module-level ``METRICS`` registry feeds transport health into
``ServingScheduler.stats()``.
"""

from __future__ import annotations

import hashlib
import random
import socket
import struct
import threading
import time

from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.metrics import RECOVERY_BUCKETS_MS, MetricsRegistry

MAGIC = b"RPRG"
WIRE_VERSION = 1
#: MAGIC + version byte + u64 length + sha256 digest
HEADER_LEN = len(MAGIC) + 1 + 8 + 32
#: hard cap on envelope size — a lying length field must not balloon memory
MAX_ENVELOPE_BYTES = 16 << 20


class TransportError(RuntimeError):
    """Program distribution over the transport failed; message names why."""


class FrameError(TransportError):
    """The wire frame is corrupt (truncation, bad magic/version/length,
    checksum mismatch) — names the exact corruption."""


class TransportTimeout(TransportError):
    """A connect or read deadline elapsed; names which and where."""


class FetchRetriesExhausted(TransportError):
    """Every fetch attempt failed; carries the attempt count and last error."""

    def __init__(self, endpoint: str, attempts: int, last: Exception):
        super().__init__(
            f"fetch from {endpoint} failed after {attempts} attempt(s); "
            f"last error: {type(last).__name__}: {last}")
        self.endpoint = endpoint
        self.attempts = attempts
        self.last = last


# ------------------------------------------------------------------ metrics
#: process-wide transport health — merged into ``ServingScheduler.stats()``
METRICS = MetricsRegistry()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


def reset_metrics() -> None:
    METRICS.reset()


# ------------------------------------------------------------------- frames
def encode_frame(payload: bytes) -> bytes:
    """Frame an envelope for the wire: magic, version, length, checksum."""
    if len(payload) > MAX_ENVELOPE_BYTES:
        raise FrameError(f"envelope of {len(payload)} bytes exceeds the "
                         f"{MAX_ENVELOPE_BYTES}-byte transport cap")
    return (MAGIC + bytes([WIRE_VERSION]) + struct.pack(">Q", len(payload))
            + hashlib.sha256(payload).digest() + payload)


def decode_header(header: bytes) -> tuple[int, bytes]:
    """Validate a frame header; returns (payload length, expected digest)."""
    if len(header) != HEADER_LEN:
        raise FrameError(f"frame header is {len(header)} bytes, "
                         f"expected {HEADER_LEN}")
    if header[:4] != MAGIC:
        raise FrameError(f"bad frame magic {header[:4]!r} != {MAGIC!r} — "
                         f"not a program envelope stream")
    version = header[4]
    if version != WIRE_VERSION:
        raise FrameError(f"unsupported wire version {version} "
                         f"(this build speaks {WIRE_VERSION})")
    (length,) = struct.unpack(">Q", header[5:13])
    if length <= 0:
        raise FrameError(f"frame declares a non-positive payload length "
                         f"{length}")
    if length > MAX_ENVELOPE_BYTES:
        raise FrameError(f"frame declares {length} payload bytes, over the "
                         f"{MAX_ENVELOPE_BYTES}-byte transport cap")
    return int(length), header[13:13 + 32]


def _read_exact(sock: socket.socket, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or fail naming the truncation/stall point."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(65536, n - got))
        except socket.timeout:
            raise TransportTimeout(
                f"read timed out after {got}/{n} bytes of {what} — "
                f"stalled sender") from None
        if not chunk:
            raise FrameError(f"connection closed after {got}/{n} bytes of "
                             f"{what} — truncated frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock: socket.socket) -> bytes:
    """Read and verify one frame; returns the payload or raises naming the
    corruption (truncation, bad header, checksum mismatch)."""
    length, want = decode_header(_read_exact(sock, HEADER_LEN,
                                             "the frame header"))
    payload = _read_exact(sock, length, "the envelope payload")
    digest = hashlib.sha256(payload).digest()
    if digest != want:
        raise FrameError(
            f"frame checksum mismatch: payload sha256 {digest.hex()[:12]}... "
            f"!= header's {want.hex()[:12]}... — bytes were corrupted in "
            f"transit")
    return payload


# ------------------------------------------------------------------- server
class ProgramServer:
    """Leader-side envelope server: every accepted connection receives one
    framed copy of the published envelope, then the connection closes.

    Push-only by design — there is nothing to request (the envelope is the
    whole catalog), so the protocol has no client→server bytes at all and a
    malicious client cannot make the leader parse anything. Each connection
    is served on its own daemon thread so one slow (or slow-loris) follower
    never blocks the accept loop."""

    def __init__(self, blob: bytes, host: str = "127.0.0.1", port: int = 0,
                 send_timeout_s: float = 10.0):
        self._frame = encode_frame(blob)
        self.blob_bytes = len(blob)
        self.host = host
        self._requested_port = port
        self.port: int | None = None
        self.send_timeout_s = float(send_timeout_s)
        self.serves = 0
        self._lock = threading.Lock()
        self._served_cv = threading.Condition(self._lock)
        self._stop = False
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ProgramServer":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self._requested_port))
        sock.listen(16)
        sock.settimeout(0.1)              # poll the stop flag
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name=f"program-server-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "ProgramServer":
        return self.start() if self.port is None else self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    @property
    def endpoint(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def await_serves(self, n: int, timeout_s: float = 30.0) -> bool:
        """Block until ``n`` envelope fetches have completed (the leader's
        barrier before exiting a launch) or the timeout elapses."""
        deadline = time.monotonic() + timeout_s
        with self._served_cv:
            while self.serves < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._served_cv.wait(timeout=remaining)
            return True

    # ------------------------------------------------------------ serving
    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                     # listener closed by stop()
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.send_timeout_s)
            conn.sendall(self._frame)
            with self._served_cv:
                self.serves += 1
                self._served_cv.notify_all()
            METRICS.inc("serves")
        except OSError:
            METRICS.inc("serve_failures")  # follower vanished mid-send
        finally:
            try:
                conn.close()
            except OSError:
                pass


def tcp_publisher(host: str = "127.0.0.1", port: int = 0):
    """A ``broadcast_program``-compatible publish hook: publishing starts a
    ``ProgramServer`` for the envelope and parks it on ``publish.server`` so
    the caller can ``await_serves``/``stop`` it (the server outlives the
    publish call on purpose — followers fetch later)."""

    def publish(blob: bytes) -> None:
        with ttrace.span("transport.publish", "system",
                         attrs={"bytes": len(blob)},
                         meta={"endpoint": f"tcp://{host}:{port}"}):
            server = ProgramServer(blob, host=host, port=port).start()
        publish.server = server
        METRICS.inc("publishes")
        METRICS.inc("publish_bytes", len(blob))

    publish.server = None
    return publish


# ------------------------------------------------------------------ fetcher
def backoff_schedule(retries: int, base_s: float, seed: int) -> list[float]:
    """The exact sleep before each re-attempt: exponential in the attempt
    index with multiplicative jitter in [1, 2) from a seeded rng. A pure
    function of (retries, base_s, seed) — chaos tests replay retry timing
    bit-for-bit, and two followers with different seeds never thundering-herd
    the leader in lockstep."""
    rng = random.Random(seed)
    return [base_s * (2 ** i) * (1.0 + rng.random()) for i in range(retries)]


def fetch_bytes(host: str, port: int, *, connect_timeout_s: float = 5.0,
                read_timeout_s: float = 5.0, retries: int = 3,
                backoff_s: float = 0.05, seed: int = 0) -> bytes:
    """Fetch one verified envelope from a leader's ``ProgramServer``.

    Bounded everywhere: connect timeout, read timeout, ``retries``
    re-attempts with seeded-jitter exponential backoff, and the frame length
    cap. Returns the checksum-verified payload bytes or raises
    ``FetchRetriesExhausted`` wrapping the last typed failure — never returns
    bytes it could not verify, never hangs."""
    endpoint = f"tcp://{host}:{port}"
    sleeps = backoff_schedule(retries, backoff_s, seed)
    attempts = retries + 1
    rec = ttrace.get()
    span = rec.begin("transport.fetch", "system",
                     meta={"endpoint": endpoint})
    last: Exception | None = None
    for attempt in range(attempts):
        METRICS.inc("fetch_attempts")
        if attempt:
            METRICS.inc("fetch_retries")
        t0 = time.perf_counter()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.settimeout(connect_timeout_s)
            try:
                sock.connect((host, port))
            except socket.timeout:
                raise TransportTimeout(
                    f"connect to {endpoint} timed out after "
                    f"{connect_timeout_s}s") from None
            sock.settimeout(read_timeout_s)
            payload = read_frame(sock)
            METRICS.inc("fetches")
            METRICS.inc("fetch_bytes", len(payload))
            METRICS.observe("fetch_ms", 1e3 * (time.perf_counter() - t0),
                            RECOVERY_BUCKETS_MS)
            rec.end(span, attrs={"bytes": len(payload),
                                 "attempts": attempt + 1,
                                 "retries": attempt})
            return payload
        except (TransportError, OSError) as e:
            last = e
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if attempt < retries:
            time.sleep(sleeps[attempt])
    METRICS.inc("fetch_failures")
    exhausted = FetchRetriesExhausted(endpoint, attempts, last)
    rec.end(span, attrs={"attempts": attempts, "retries": retries,
                         "error": type(last).__name__})
    raise exhausted


def tcp_fetcher(host: str, port: int, **kw):
    """A ``broadcast_program``-compatible fetch hook over ``fetch_bytes``."""

    def fetch() -> bytes:
        return fetch_bytes(host, port, **kw)

    return fetch


def fetch_program(host: str, port: int, artifact, *, device="cuda",
                  cache: bool = True, **kw):
    """Fetch + MANDATORY fingerprint re-verification: the envelope goes
    through ``deserialize_program`` (artifact fingerprint, per-array hashes,
    recomputed program fingerprint) before the program may enter the local
    ``ProgramCache`` on ``device`` — transport checksums alone never admit a
    program."""
    from repro_torch.core.lowering import resolve_device
    from repro_torch.core.program_io import deserialize_program

    device = resolve_device(device)         # before any byte is fetched
    blob = fetch_bytes(host, port, **kw)
    return deserialize_program(blob, artifact, device=device, cache=cache)
