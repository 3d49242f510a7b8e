"""Fault-injecting transport proxy + the *detected-or-bit-exact* invariant.

The port of ``repro.conformance.transport_faults``: the same 27 scenarios,
timeouts and verdicts, with ``deserialize_program`` onto a ``device``.

The network transport's whole value is the guarantee it makes under
corruption: a follower either reconstructs a program FINGERPRINT-IDENTICAL
to the leader's, or fails loudly with a typed error naming the corruption —
never a silently divergent program. This module is the adversarial harness
that proves it: ``FaultyProxy`` sits between a real ``ProgramServer`` and a
real ``fetch_bytes`` client as an in-process TCP proxy, and applies one
packet-level fault per scenario — truncations at every frame boundary,
flipped header/payload bytes, re-framed tampering (a "smart" attacker who
recomputes the frame checksum over a modified envelope, so only the
program-layer fingerprints can catch it), stale envelope replays, duplicate
frames, mid-envelope connection resets, stalled and slow-loris writers —
plus transient variants that fault the first connection(s) and then heal,
exercising the retry arm end to end.

``run_scenario`` classifies each fetch into one of

  * ``bitexact``          — fetch + ``deserialize_program`` succeeded and the
                            program fingerprint equals the leader's;
  * ``detected``          — a typed ``TransportError`` / ``ProgramIOError``
                            named the corruption;
  * ``silent-divergence`` — success with a DIFFERENT fingerprint (the
                            invariant violation this suite exists to forbid);
  * ``unexpected-error``  — an untyped crash (also a violation: failures
                            must be diagnosable).

``run_suite`` sweeps every scenario; the ``transport`` conformance oracle
runs a seed-rotated window per fuzzed case.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time

from repro_torch.core.lowering import resolve_device
from repro_torch.core.program_io import ProgramIOError, deserialize_program
from repro_torch.distributed import transport as tp

#: every scenario's client runs with these tight-but-real bounds so the
#: persistent stall/reset cases resolve in well under a second
CLIENT_KW = dict(connect_timeout_s=1.0, read_timeout_s=0.08, retries=2,
                 backoff_s=0.01)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One packet-level fault. ``kind`` names the primitive the proxy
    applies; ``expect`` is the invariant arm the scenario must land on;
    ``faulty_conns`` bounds how many connections see the fault (a huge
    default = persistent; 1–2 = transient, healed by the retry arm)."""

    name: str
    kind: str
    expect: str                 # "bitexact" | "detected"
    faulty_conns: int = 1 << 30
    note: str = ""


SCENARIOS: tuple[Scenario, ...] = (
    Scenario("clean", "clean", "bitexact",
             note="control: the proxy forwards verbatim"),
    # ---- truncations at every frame boundary --------------------------
    Scenario("truncate-header", "truncate-header", "detected",
             note="3 bytes of a 45-byte header, then close"),
    Scenario("truncate-mid-payload", "truncate-mid", "detected",
             note="half the frame, then close"),
    Scenario("truncate-last-byte", "truncate-tail", "detected",
             note="everything but the final byte"),
    Scenario("empty-close", "empty", "detected",
             note="accept then close without a byte"),
    # ---- corrupt headers ----------------------------------------------
    Scenario("flip-magic", "flip-magic", "detected"),
    Scenario("flip-version", "flip-version", "detected"),
    Scenario("length-overflow", "length-huge", "detected",
             note="length field claims 2**48 bytes"),
    Scenario("length-short", "length-short", "detected",
             note="length field shrunk by 7 — checksum catches it"),
    Scenario("length-long", "length-long", "detected",
             note="length field grown by 7 — truncation catches it"),
    Scenario("flip-checksum", "flip-checksum", "detected"),
    Scenario("junk-bytes", "junk", "detected",
             note="64 random bytes instead of a frame"),
    # ---- corrupt payloads ---------------------------------------------
    Scenario("flip-payload-byte", "flip-payload", "detected",
             note="frame checksum catches the flip"),
    Scenario("flip-payload-reframed", "reframe-flip", "detected",
             note="attacker recomputes the checksum; program-io catches it"),
    Scenario("tamper-scalar-reframed", "reframe-scalar", "detected",
             note="scalars['T'] altered, valid frame; program "
                  "fingerprint catches it"),
    Scenario("tamper-array-hash-reframed", "reframe-array-hash", "detected",
             note="array digest altered, valid frame; array hash check "
                  "names the array"),
    # ---- replay / duplication -----------------------------------------
    Scenario("stale-envelope-replay", "stale", "detected",
             note="a VALID envelope for a different artifact; artifact "
                  "fingerprint catches it"),
    Scenario("duplicate-frame", "duplicate", "bitexact",
             note="the same frame twice; the fetcher reads exactly one"),
    Scenario("trailing-junk", "trailing-junk", "bitexact",
             note="garbage after a complete frame is never read"),
    # ---- connection pathologies ---------------------------------------
    Scenario("reset-mid-envelope", "reset-mid", "detected",
             note="RST after half the frame"),
    Scenario("stall-header", "stall-header", "detected",
             note="connected but silent; read deadline fires"),
    Scenario("stall-mid-payload", "stall-mid", "detected",
             note="half the frame then silence"),
    Scenario("slow-loris", "slow-loris", "detected",
             note="one byte per interval, slower than the read deadline"),
    # ---- transient faults: the retry arm must heal them ---------------
    Scenario("transient-truncate", "truncate-mid", "bitexact",
             faulty_conns=1, note="first fetch truncated, retry is clean"),
    Scenario("transient-reset", "reset-mid", "bitexact",
             faulty_conns=1, note="first fetch reset, retry is clean"),
    Scenario("transient-stall", "stall-header", "bitexact",
             faulty_conns=1, note="first fetch stalls, retry is clean"),
    Scenario("transient-flip-twice", "flip-payload", "bitexact",
             faulty_conns=2,
             note="two corrupted fetches, the third (last) retry is clean"),
)


class FaultyProxy:
    """In-process TCP proxy between a fetcher and a ``ProgramServer``.

    Per client connection it pulls the COMPLETE upstream frame first, then
    replays it through the scenario's fault primitive — faults are applied
    to known-good bytes, so every scenario tests exactly one corruption, not
    a compound of proxy timing and fault."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 scenario: Scenario, *, seed: int = 0,
                 stall_s: float = 0.25, stale_blob: bytes | None = None):
        self.upstream = (upstream_host, upstream_port)
        self.scenario = scenario
        self.rng = random.Random(seed)
        self.stall_s = float(stall_s)
        self.stale_blob = stale_blob
        self.host = "127.0.0.1"
        self.port: int | None = None
        self.connections = 0
        self._lock = threading.Lock()
        self._stop = False
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "FaultyProxy":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, 0))
        sock.listen(16)
        sock.settimeout(0.05)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
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
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "FaultyProxy":
        return self.start() if self.port is None else self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

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
                return
            with self._lock:
                index = self.connections
                self.connections += 1
            threading.Thread(target=self._serve_one, args=(conn, index),
                             daemon=True).start()

    # -------------------------------------------------------------- faults
    def _upstream_frame(self) -> bytes:
        up = socket.create_connection(self.upstream, timeout=2.0)
        try:
            chunks = []
            while True:
                chunk = up.recv(65536)
                if not chunk:
                    return b"".join(chunks)
                chunks.append(chunk)
        finally:
            up.close()

    def _payload_of(self, frame: bytes) -> bytes:
        return frame[tp.HEADER_LEN:]

    def _serve_one(self, conn: socket.socket, index: int) -> None:
        try:
            conn.settimeout(5.0)
            data = self._upstream_frame()
            kind = (self.scenario.kind
                    if index < self.scenario.faulty_conns else "clean")
            self._apply(conn, kind, data)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _apply(self, conn: socket.socket, kind: str, data: bytes) -> None:
        half = len(data) // 2
        if kind == "clean":
            conn.sendall(data)
        elif kind == "truncate-header":
            conn.sendall(data[:3])
        elif kind == "truncate-mid":
            conn.sendall(data[:half])
        elif kind == "truncate-tail":
            conn.sendall(data[:-1])
        elif kind == "empty":
            pass
        elif kind == "flip-magic":
            conn.sendall(self._flip(data, 0))
        elif kind == "flip-version":
            conn.sendall(self._flip(data, 4))
        elif kind == "length-huge":
            conn.sendall(self._with_length(data, 1 << 48))
        elif kind == "length-short":
            conn.sendall(self._with_length(data, self._length(data) - 7))
        elif kind == "length-long":
            conn.sendall(self._with_length(data, self._length(data) + 7))
        elif kind == "flip-checksum":
            conn.sendall(self._flip(data, 13))
        elif kind == "junk":
            conn.sendall(bytes(self.rng.randrange(256) for _ in range(64)))
        elif kind == "flip-payload":
            conn.sendall(self._flip(data, tp.HEADER_LEN + half // 2))
        elif kind == "reframe-flip":
            payload = bytearray(self._payload_of(data))
            payload[self.rng.randrange(len(payload))] ^= 0x20
            conn.sendall(tp.encode_frame(bytes(payload)))
        elif kind == "reframe-scalar":
            conn.sendall(tp.encode_frame(self._tamper_scalar(data)))
        elif kind == "reframe-array-hash":
            conn.sendall(tp.encode_frame(self._tamper_array_hash(data)))
        elif kind == "stale":
            conn.sendall(tp.encode_frame(self.stale_blob))
        elif kind == "duplicate":
            conn.sendall(data + data)
        elif kind == "trailing-junk":
            conn.sendall(data + b"\xde\xad\xbe\xef" * 8)
        elif kind == "reset-mid":
            conn.sendall(data[:half])
            # SO_LINGER(on, 0): close() sends RST, not FIN — the client
            # sees ECONNRESET mid-frame, not a clean truncation
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            b"\x01\x00\x00\x00\x00\x00\x00\x00")
        elif kind == "stall-header":
            time.sleep(self.stall_s)
        elif kind == "stall-mid":
            conn.sendall(data[:half])
            time.sleep(self.stall_s)
        elif kind == "slow-loris":
            for i in range(4):
                conn.sendall(data[i:i + 1])
                time.sleep(self.stall_s / 2)
        else:
            raise AssertionError(f"unknown fault kind {kind!r}")

    @staticmethod
    def _flip(data: bytes, index: int) -> bytes:
        out = bytearray(data)
        out[index] ^= 0xFF
        return bytes(out)

    @staticmethod
    def _length(data: bytes) -> int:
        return int.from_bytes(data[5:13], "big")

    @staticmethod
    def _with_length(data: bytes, length: int) -> bytes:
        out = bytearray(data)
        out[5:13] = int(length).to_bytes(8, "big")
        return bytes(out)

    def _tamper_scalar(self, data: bytes) -> bytes:
        import json
        env = json.loads(self._payload_of(data))
        env["scalars"]["T"] = int(env["scalars"]["T"]) + 1
        return json.dumps(env, sort_keys=True,
                          separators=(",", ":")).encode()

    def _tamper_array_hash(self, data: bytes) -> bytes:
        import json
        env = json.loads(self._payload_of(data))
        name = sorted(env["arrays"])[0]
        digest = env["arrays"][name]
        env["arrays"][name] = ("0" if digest[0] != "0" else "1") + digest[1:]
        return json.dumps(env, sort_keys=True,
                          separators=(",", ":")).encode()


def run_scenario(scenario: Scenario, *, blob: bytes, artifact,
                 leader_fingerprint: str, stale_blob: bytes | None = None,
                 seed: int = 0, stall_s: float = 0.25,
                 client_kw: dict | None = None, device="cuda") -> dict:
    """One scenario end to end: real server, faulty proxy, real fetcher +
    ``deserialize_program`` onto ``device``. Returns a verdict dict whose
    ``ok`` field is the detected-or-bit-exact invariant for this
    scenario."""
    if scenario.kind == "stale" and stale_blob is None:
        raise ValueError("the stale-replay scenario needs a stale_blob "
                         "(a valid envelope for a DIFFERENT artifact)")
    device = resolve_device(device)    # outside the classified region
    kw = dict(CLIENT_KW)
    if client_kw:
        kw.update(client_kw)
    t0 = time.perf_counter()
    outcome, detail = "bitexact", ""
    with tp.ProgramServer(blob) as upstream:
        with FaultyProxy(upstream.host, upstream.port, scenario, seed=seed,
                         stall_s=stall_s, stale_blob=stale_blob) as proxy:
            try:
                fetched = tp.fetch_bytes(proxy.host, proxy.port, seed=seed,
                                         **kw)
                prog = deserialize_program(fetched, artifact, device=device,
                                           cache=False)
                if prog.fingerprint != leader_fingerprint:
                    outcome = "silent-divergence"
                    detail = (f"fetched program {prog.fingerprint[:12]}... "
                              f"!= leader {leader_fingerprint[:12]}...")
            except tp.FetchRetriesExhausted as e:
                outcome = "detected"
                detail = f"{type(e.last).__name__}: {e.last}"
            except (tp.TransportError, ProgramIOError) as e:
                outcome = "detected"
                detail = f"{type(e).__name__}: {e}"
            except Exception as e:            # noqa: BLE001 — classified
                outcome = "unexpected-error"
                detail = f"{type(e).__name__}: {e}"
            connections = proxy.connections
    return {"scenario": scenario.name, "kind": scenario.kind,
            "expect": scenario.expect, "outcome": outcome,
            "ok": outcome == scenario.expect, "detail": detail,
            "connections": connections, "note": scenario.note,
            "wall_ms": 1e3 * (time.perf_counter() - t0)}


def run_suite(blob: bytes, artifact, leader_fingerprint: str, *,
              stale_blob: bytes | None = None,
              scenarios: tuple = SCENARIOS, seed: int = 0,
              stall_s: float = 0.25, device="cuda") -> list[dict]:
    """Every scenario's verdict (skipping stale-replay when no stale blob
    is supplied)."""
    verdicts = []
    for sc in scenarios:
        if sc.kind == "stale" and stale_blob is None:
            continue
        verdicts.append(run_scenario(
            sc, blob=blob, artifact=artifact,
            leader_fingerprint=leader_fingerprint, stale_blob=stale_blob,
            seed=seed, stall_s=stall_s, device=device))
    return verdicts
