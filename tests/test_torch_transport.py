"""The port's TCP program transport, broadcast over it, the cluster grammar,
the fault-injecting proxy and the launcher's SNN roles, against the JAX
package on the CPU: frames byte for byte and JAX's header rejections word
for word, the wire crossed both ways (a JAX server feeding the port's
fetcher and the port's server feeding JAX's), seeded backoff equal to
JAX's, spans and the scheduler's ``transport_*`` stats, ``parse_transport``
on JAX's table, all 27 fault scenarios with JAX's verdicts, and two
launcher processes (leader and follower over tcp port 0) serving JAX's
reference labels."""

import io
import os
import re
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.conformance.transport_faults import run_suite as jrun_suite
from repro.core.artifact import Artifact as JArtifact
from repro.core.lowering import lower as jlower
from repro.core.program_io import serialize_program as jserialize
from repro.distributed import transport as jtp
from repro.launch.cluster import parse_transport as jparse_transport
from repro.serving.snn_engine import SNNServeEngine as JEngine
from repro_torch.conformance.golden import PINNED_SEEDS
from repro_torch.conformance.oracles import _transport_oracle
from repro_torch.conformance.transport_faults import (SCENARIOS, run_scenario,
                                                      run_suite)
from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import ProgramCache, install, lower
from repro_torch.core.program_io import (ProgramIOError, envelope_digest,
                                         serialize_program)
from repro_torch.distributed import transport as tp
from repro_torch.launch import cluster
from repro_torch.launch.cluster import Endpoint, parse_transport
from repro_torch.launch.mesh import broadcast_program
from repro_torch.serving.scheduler import ServingScheduler
from repro_torch.serving.snn_engine import SNNServeEngine
from repro_torch.telemetry import trace as ttrace

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
MNIST_ART = os.path.join(ASSETS, "mnist_ttfs.npz")
CPU = torch.device("cpu")

TRANSPORT_KEYS = ("transport_publishes", "transport_serves",
                  "transport_fetches", "transport_fetch_bytes",
                  "transport_fetch_retries", "transport_fetch_failures",
                  "transport_fetch_ms_p95")


@pytest.fixture(scope="module")
def mnist():
    """The MNIST artifact in both packages, its program on the CPU and its
    envelope; the stale replay's envelope is fuzz seed 0's (a valid
    envelope of another artifact)."""
    art = Artifact.load(MNIST_ART)
    prog = lower(art, device=CPU, cache=False)
    with np.load(os.path.join(ASSETS, "transport_expected.npz")) as z:
        stale = z["envelope_fuzz_seed0"].tobytes()
    return art, JArtifact.load(MNIST_ART), prog, serialize_program(prog), \
        stale


@pytest.fixture()
def scoped_cache():
    cache = ProgramCache()
    prev = install(cache)
    yield cache
    install(prev)


def _serve_raw(data: bytes):
    """One-shot raw-byte server for crafting invalid frames on the wire."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    host, port = sock.getsockname()

    def serve():
        conn, _ = sock.accept()
        conn.sendall(data)
        conn.close()
        sock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return host, port, t


# ------------------------------------------------------------ frame codec
def test_frame_roundtrip_equals_jax():
    payload = b'{"hello": "program"}'
    frame = tp.encode_frame(payload)
    assert frame == jtp.encode_frame(payload)
    assert (tp.MAGIC, tp.WIRE_VERSION, tp.HEADER_LEN,
            tp.MAX_ENVELOPE_BYTES) == (jtp.MAGIC, jtp.WIRE_VERSION,
                                       jtp.HEADER_LEN, jtp.MAX_ENVELOPE_BYTES)
    length, digest = tp.decode_header(frame[:tp.HEADER_LEN])
    assert length == len(payload) and frame[tp.HEADER_LEN:] == payload
    assert digest == bytes.fromhex(envelope_digest(payload))


def _bad_header(kind: str) -> bytes:
    frame = bytearray(tp.encode_frame(b"payload"))
    if kind == "short":
        return bytes(frame[:3])
    if kind == "magic":
        frame[0] ^= 0xFF
    elif kind == "version":
        frame[4] = 99
    elif kind == "over cap":
        frame[5:13] = (tp.MAX_ENVELOPE_BYTES + 1).to_bytes(8, "big")
    elif kind == "zero length":
        frame[5:13] = (0).to_bytes(8, "big")
    return bytes(frame[:tp.HEADER_LEN])


@pytest.mark.parametrize("kind,needle", [
    ("short", "header is 3 bytes"), ("magic", "magic"),
    ("version", "wire version 99"), ("over cap", "transport cap"),
    ("zero length", "non-positive")])
def test_frame_header_rejections_keep_jax_messages(kind, needle):
    header = _bad_header(kind)
    with pytest.raises(tp.FrameError, match=needle) as ei:
        tp.decode_header(header)
    with pytest.raises(jtp.FrameError) as ej:
        jtp.decode_header(header)
    assert str(ei.value) == str(ej.value)


def test_oversized_envelope_is_refused():
    with pytest.raises(tp.FrameError, match="transport cap"):
        tp.encode_frame(b"\x00" * (tp.MAX_ENVELOPE_BYTES + 1))


@pytest.mark.parametrize("cut,needle", [
    (lambda f: f[:-1] + bytes([f[-1] ^ 1]), "checksum mismatch"),
    (lambda f: f[:-2], "truncated frame")])
def test_corrupt_frames_are_detected_on_the_wire(cut, needle):
    host, port, t = _serve_raw(cut(tp.encode_frame(b"the quick program")))
    with pytest.raises(tp.FetchRetriesExhausted) as ei:
        tp.fetch_bytes(host, port, retries=0, read_timeout_s=1.0)
    assert isinstance(ei.value.last, tp.FrameError)
    assert needle in str(ei.value.last)
    t.join(timeout=5)


# -------------------------------------------------------- server + fetcher
def test_server_counts_serves_and_awaits(mnist):
    blob = mnist[3]
    with tp.ProgramServer(blob) as srv:
        assert not srv.await_serves(1, timeout_s=0.05)
        for _ in range(3):
            assert tp.fetch_bytes(srv.host, srv.port) == blob
        assert srv.await_serves(3, timeout_s=5.0) and srv.serves == 3
    assert srv.endpoint == f"tcp://127.0.0.1:{srv.port}"


def test_fetch_from_dead_endpoint_exhausts_retries():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    before = tp.metrics_snapshot().get("fetch_failures", 0)
    with pytest.raises(tp.FetchRetriesExhausted) as ei:
        tp.fetch_bytes("127.0.0.1", port, retries=2, backoff_s=0.005,
                       connect_timeout_s=0.5)
    assert ei.value.attempts == 3 and ei.value.endpoint.endswith(str(port))
    assert tp.metrics_snapshot().get("fetch_failures", 0) == before + 1


@pytest.mark.parametrize("retries,base,seed", [
    (0, 0.05, 0), (3, 0.05, 0), (4, 0.05, 3), (4, 0.05, 4), (6, 0.01, 11),
    (2, 1.5, 2 ** 31 - 1)])
def test_backoff_schedule_equals_jax(retries, base, seed):
    got = tp.backoff_schedule(retries, base, seed)
    assert got == jtp.backoff_schedule(retries, base, seed)
    assert len(got) == retries
    for i, sleep in enumerate(got):
        assert base * 2 ** i <= sleep < 2 * base * 2 ** i


# -------------------------------------------------- the wire, across stacks
def test_jax_server_feeds_the_ports_fetcher(mnist, scoped_cache):
    art, jart, prog, blob, _ = mnist
    jblob = jserialize(jlower(jart, cache=False))
    with jtp.ProgramServer(jblob) as srv:
        assert tp.fetch_bytes(srv.host, srv.port) == blob
        got = tp.fetch_program(srv.host, srv.port, art, device=CPU)
        follower = broadcast_program(
            art, leader=False, device=CPU,
            fetch=tp.tcp_fetcher(srv.host, srv.port))
    assert got.fingerprint == prog.fingerprint and follower is got
    assert scoped_cache.stats()["program_misses"] == 0


def test_ports_server_feeds_jax_fetcher(mnist):
    _, jart, prog, blob, _ = mnist
    publish = tp.tcp_publisher()
    publish(blob)
    server = publish.server
    try:
        assert jtp.fetch_bytes(server.host, server.port) == blob
        jprog = jtp.fetch_program(server.host, server.port, jart,
                                  cache=False)
        # a serve counts after its last byte is sent, on its own thread,
        # which may not have run yet when the fetcher has every byte
        server.await_serves(2, timeout_s=10.0)
    finally:
        server.stop()
    assert jprog.fingerprint == prog.fingerprint
    assert server.serves == 2


def test_fetch_program_verifies_against_wrong_artifact(mnist):
    blob = mnist[3]
    with np.load(os.path.join(ASSETS, "fuzz_seed1.npz")) as z:
        other = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
    with tp.ProgramServer(blob) as srv:
        with pytest.raises(ProgramIOError, match="artifact fingerprint"):
            tp.fetch_program(srv.host, srv.port, other, device=CPU,
                             cache=False)


# --------------------------------------------------------------- telemetry
def test_publish_and_fetch_emit_spans(mnist):
    blob = mnist[3]
    tracer = ttrace.Tracer()
    prev = ttrace.install(tracer)
    try:
        publish = tp.tcp_publisher()
        publish(blob)
        server = publish.server
        try:
            tp.fetch_bytes(server.host, server.port)
        finally:
            server.stop()
    finally:
        ttrace.install(prev)
    (pub,) = tracer.find("transport.publish")
    assert pub.scope == "system" and pub.attrs["bytes"] == len(blob)
    (fetch,) = tracer.find("transport.fetch")
    assert fetch.scope == "system"
    assert fetch.attrs == {"bytes": len(blob), "attempts": 1, "retries": 0}
    assert "endpoint" in fetch.meta and "endpoint" not in fetch.attrs


def test_scheduler_stats_surface_transport_health(mnist, scoped_cache):
    art, jart, _, blob, _ = mnist
    tp.reset_metrics()
    with tp.ProgramServer(blob) as srv:
        tp.fetch_bytes(srv.host, srv.port)
    with ServingScheduler(art, spec="reference", max_batch=4,
                          device=CPU) as s:
        st = s.stats()
    assert st["transport_fetches"] == 1 and st["transport_serves"] == 1
    assert st["transport_fetch_bytes"] == len(blob)
    assert st["transport_fetch_retries"] == 0
    assert st["transport_fetch_failures"] == 0
    assert st["transport_publishes"] == 0
    assert st["transport_fetch_ms_p95"] > 0.0
    # the seven keys are JAX's, and the engine facade carries them too
    eng = SNNServeEngine(art, max_batch=4, device=CPU)
    jeng = JEngine(jart, max_batch=4)
    got = {k for k in eng.stats() if k.startswith("transport_")}
    want = {k for k in jeng.stats() if k.startswith("transport_")}
    eng.close()
    jeng.close()
    assert got == want == set(TRANSPORT_KEYS)
    tp.reset_metrics()


# ------------------------------------------------------- transport grammar
@pytest.mark.parametrize("spec", [
    "tcp://10.0.0.7:7070", "tcp://leader:0", "tcp://[::1]:65535",
    " tcp://h:1 ", "file:///shared/prog.json", "/shared/prog.json",
    "relative/prog.json", "", "   ", "tcp://noport", "tcp://:80",
    "tcp://h:notanint", "tcp://h:70000", "tcp://h:-1", "file://",
    "udp://h:1", None])
def test_parse_transport_agrees_with_jax(spec):
    try:
        want = jparse_transport(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            parse_transport(spec)
        assert str(ei.value) == str(e)
        return
    got = parse_transport(spec)
    assert isinstance(got, Endpoint)
    assert (got.scheme, got.host, got.port, got.path, str(got)) == \
        (want.scheme, want.host, want.port, want.path, str(want))


def test_distribute_program_over_tcp_and_file(mnist, scoped_cache, tmp_path,
                                              monkeypatch):
    art, _, prog, _, _ = mnist
    leader, handle = cluster.distribute_program(
        art, "tcp://127.0.0.1:0", role="leader", device=CPU)
    seen: dict = {}
    real = tp.tcp_fetcher

    def spy(host, port, **kw):
        seen.update(kw)
        return real(host, port, **kw)

    monkeypatch.setattr(tp, "tcp_fetcher", spy)
    with handle:
        assert re.fullmatch(r"tcp://127\.0\.0\.1:\d+", handle.endpoint)
        follower_cache = ProgramCache()
        prev = install(follower_cache)
        try:
            follower, inert = cluster.distribute_program(
                art, handle.endpoint, role="follower", timeout_s=8.0,
                device=CPU)
        finally:
            install(prev)
        assert handle.await_fetches(1, timeout_s=5.0) and handle.serves == 1
    # each try gets an equal slice of the budget: max(0.05, 8 / 4 / 2)
    assert seen["connect_timeout_s"] == seen["read_timeout_s"] == 1.0
    assert inert.endpoint is None and inert.await_fetches(3)
    assert follower.fingerprint == leader.fingerprint == prog.fingerprint
    assert follower_cache.stats()["program_misses"] == 0
    path = str(tmp_path / "envelope.json")
    _, fhandle = cluster.distribute_program(art, path, role="leader",
                                            device=CPU)
    assert fhandle.endpoint is None
    follower_cache = ProgramCache()
    prev = install(follower_cache)
    try:
        got, _ = cluster.distribute_program(art, f"file://{path}",
                                            role="follower", device=CPU)
    finally:
        install(prev)
    assert got.fingerprint == prog.fingerprint
    assert follower_cache.stats()["program_misses"] == 0
    with pytest.raises(ValueError, match="role must be"):
        cluster.distribute_program(art, path, role="observer", device=CPU)


# ------------------------------------------------- fault-proxy conformance
def test_fault_suite_verdicts_equal_jax(mnist):
    art, jart, prog, blob, stale = mnist
    got = run_suite(blob, art, prog.fingerprint, stale_blob=stale, seed=5,
                    device=CPU)
    want = jrun_suite(blob, jart, prog.fingerprint, stale_blob=stale, seed=5)
    assert len(got) == len(want) == len(SCENARIOS) == 27
    for g, w in zip(got, want):
        assert (g["scenario"], g["kind"], g["expect"], g["outcome"],
                g["ok"]) == (w["scenario"], w["kind"], w["expect"],
                             w["outcome"], w["ok"])
        assert g["detail"].split(":")[0] == w["detail"].split(":")[0], \
            (g["scenario"], g["detail"], w["detail"])
    bad = [v for v in got if not v["ok"]]
    assert not bad, bad
    assert all(v["outcome"] in ("detected", "bitexact") for v in got)


@pytest.mark.parametrize("name,needle", [
    ("flip-checksum", "checksum mismatch"),
    ("truncate-last-byte", "truncated frame"),
    ("flip-version", "wire version"),
    ("tamper-array-hash-reframed", "hash mismatch"),
    ("stale-envelope-replay", "artifact fingerprint")])
def test_detected_failures_name_the_corruption(mnist, name, needle):
    art, _, prog, blob, stale = mnist
    (sc,) = [s for s in SCENARIOS if s.name == name]
    v = run_scenario(sc, blob=blob, artifact=art, stale_blob=stale,
                     leader_fingerprint=prog.fingerprint, device=CPU)
    assert v["outcome"] == "detected" and needle in v["detail"], v


@pytest.mark.parametrize("seed", PINNED_SEEDS)
def test_transport_oracle_window(seed):
    """The oracle's seed-rotated window of four scenarios (stale replay
    excluded) on each pinned fuzz artifact."""
    with np.load(os.path.join(ASSETS, f"fuzz_seed{seed}.npz")) as z:
        art = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
    out = _transport_oracle(art, seed, CPU)
    assert out.passed, out.detail
    assert out.stats["scenarios"] == 4
    assert out.stats["detected"] + out.stats["bitexact"] == 4


# ------------------------------------------------------- the launcher roles
def test_serve_snn_leader_and_follower_processes(tmp_path):
    """Two launcher processes over tcp port 0: the follower lowers nothing,
    and both serve JAX's reference labels for JAX's request stream."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--snn-artifact", MNIST_ART, "--requests", "64",
            "--max-batch", "64", "--device", "cpu",
            "--envelope-timeout", "60"]
    leader = subprocess.Popen(
        base + ["--transport", "tcp://127.0.0.1:0", "--role", "leader",
                "--await-fetches", "1", "--labels-out",
                str(tmp_path / "leader.npy")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        first = leader.stdout.readline()
        m = re.search(r"\[leader\] publishing program at (tcp://\S+)", first)
        assert m, first
        follower = subprocess.run(
            base + ["--transport", m.group(1), "--role", "follower",
                    "--labels-out", str(tmp_path / "follower.npy")],
            capture_output=True, text=True, env=env, timeout=120)
        rest, _ = leader.communicate(timeout=120)
    finally:
        leader.kill()
        leader.wait()
    assert follower.returncode == 0, follower.stdout + follower.stderr
    assert leader.returncode == 0, rest
    assert "(cache: 0 lowered" in follower.stdout, follower.stdout
    assert "served 1/1 follower fetch(es)" in rest
    assert "(cache: 1 lowered" in rest
    with np.load(os.path.join(ASSETS, "transport_expected.npz")) as z:
        want = z["serve_labels"][:64]
    for role in ("leader", "follower"):
        got = np.load(tmp_path / f"{role}.npy")
        assert got.dtype == np.int32 and np.array_equal(got, want), role
