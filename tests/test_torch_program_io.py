"""The port's program I/O against the JAX package on the CPU: the envelope
byte for byte on MNIST and the 8 pinned fuzz artifacts, read across both
ways (JAX serializes, the port deserializes, and the reverse) into programs
equal to a fresh lowering; JAX's envelope mutations, refused; JAX's
rejection messages in JAX's order; the program cache's ``seed``/``peek``
keyed by the resolved device; the broadcast hook's leader/follower
semantics; the ``program-io`` oracle on the pinned seeds; and the committed
transport assets equal to a fresh JAX export."""

import copy
import dataclasses
import importlib.util
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.conformance.fuzz import fuzz_envelope_mutations as jmutations
from repro.conformance.golden import PINNED_SEEDS
from repro.conformance.oracles import _program_io_oracle as j_program_io
from repro.core.artifact import Artifact as JArtifact
from repro.core.lowering import lower as jlower
from repro.core.program_io import deserialize_program as jdeserialize
from repro.core.program_io import serialize_program as jserialize
from repro_torch.conformance.fuzz import fuzz_envelope_mutations
from repro_torch.conformance.oracles import _program_io_oracle
from repro_torch.core import lowering
from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import (REQUIRED_ARRAYS, ProgramCache,
                                       install, lower)
from repro_torch.core.program_io import (FORMAT_VERSION, SCALAR_FIELDS,
                                         ProgramIOError, deserialize_program,
                                         serialize_program)
from repro_torch.launch.mesh import (ProgramBroadcastError, broadcast_program,
                                     file_fetcher, file_publisher)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
CPU = torch.device("cpu")
CASES = ("mnist",) + tuple(f"fuzz_seed{s}" for s in PINNED_SEEDS)


def _load_both(case: str):
    if case == "mnist":
        path = os.path.join(ASSETS, "mnist_ttfs.npz")
        return Artifact.load(path), JArtifact.load(path)
    with np.load(os.path.join(ASSETS, f"{case}.npz")) as z:
        raw = z["artifact"].tobytes()
    return Artifact.load(io.BytesIO(raw)), JArtifact.load(io.BytesIO(raw))


@pytest.fixture(scope="module")
def arts():
    return {case: _load_both(case) for case in CASES}


@pytest.fixture(scope="module")
def expected():
    with np.load(os.path.join(ASSETS, "transport_expected.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture()
def scoped_cache():
    cache = ProgramCache()
    prev = install(cache)
    yield cache
    install(prev)


def _dump(env: dict) -> bytes:
    return json.dumps(env, sort_keys=True, separators=(",", ":")).encode()


def _assert_equal_programs(got, want):
    assert got.fingerprint == want.fingerprint
    for f in SCALAR_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert type(a) is type(b) and a == b, f
    assert got.encode == want.encode and got.decode == want.decode
    assert got.device == want.device and got.cost == want.cost
    for name in REQUIRED_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.device == b.device and a.dtype == b.dtype, name
        assert torch.equal(a, b), name


# ------------------------------------------------- the envelope, both ways
@pytest.mark.parametrize("case", CASES)
def test_envelope_equals_jax_both_ways(arts, expected, case):
    art, jart = arts[case]
    fresh = lower(art, device=CPU, cache=False)
    blob, jblob = serialize_program(fresh), jserialize(jlower(jart,
                                                             cache=False))
    assert blob == jblob
    assert blob == expected[f"envelope_{case}"].tobytes()
    # JAX serializes, the port deserializes: a fresh lowering's program
    got = deserialize_program(jblob, art, device=CPU, cache=False)
    _assert_equal_programs(got, fresh)
    assert serialize_program(got) == jblob
    # the port serializes, JAX deserializes: JAX's own lowering
    jgot = jdeserialize(blob, jart, cache=False)
    assert jgot.fingerprint == fresh.fingerprint
    assert jserialize(jgot) == blob


def test_committed_transport_assets_equal_a_fresh_jax_export(expected):
    spec = importlib.util.spec_from_file_location(
        "export_torch_fixture",
        os.path.join(ROOT, "scripts", "export_torch_fixture.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = script.transport_expected(ASSETS)
    assert set(fresh) == set(expected)
    for k, a in fresh.items():
        assert a.dtype == expected[k].dtype and np.array_equal(
            a, expected[k]), k
    assert len(expected["serve_labels"]) == script.SERVE_REQUESTS


# --------------------------------------------------------------- rejection
@pytest.mark.parametrize("seed", PINNED_SEEDS)
def test_envelope_mutations_equal_jax_and_are_refused(arts, seed):
    art, jart = arts[f"fuzz_seed{seed}"]
    blob = serialize_program(lower(art, device=CPU, cache=False))
    muts = fuzz_envelope_mutations(blob, seed)
    assert muts == jmutations(blob, seed) and len(muts) == 5
    for desc, bad in muts:
        with pytest.raises(ProgramIOError) as ei:
            deserialize_program(bad, art, device=CPU, cache=False)
        with pytest.raises(Exception) as ej:
            jdeserialize(bad, jart, cache=False)
        assert str(ei.value) == str(ej.value), desc
    # nothing was half-applied: the pristine envelope still reconstructs
    assert deserialize_program(blob, art, device=CPU, cache=False) \
        .fingerprint == lower(art, device=CPU, cache=False).fingerprint


@pytest.mark.parametrize("name", REQUIRED_ARRAYS)
def test_tampered_array_hash_names_the_array(arts, name):
    art, _ = arts["mnist"]
    env = json.loads(serialize_program(lower(art, device=CPU, cache=False)))
    digest = env["arrays"][name]
    env["arrays"][name] = ("0" if digest[0] != "0" else "1") + digest[1:]
    with pytest.raises(ProgramIOError, match=f"array '{name}' hash mismatch"):
        deserialize_program(_dump(env), art, device=CPU, cache=False)


def _tamper(kind: str, env: dict, art, blob: bytes):
    """(envelope bytes, artifact) for one rejection path of JAX's order."""
    if kind == "wrong artifact":
        meta = copy.deepcopy(art.meta)
        meta["events"]["e_max"] = int(meta["events"]["e_max"]) + 1
        return blob, (meta, dict(art.arrays))
    if kind == "not json":
        return blob[:10], None
    if kind == "empty":
        return b"", None
    if kind == "not an object":
        return b"[1, 2]", None
    if kind == "format":
        env["format"] = FORMAT_VERSION + 1
    elif kind == "missing key":
        del env["decode"]
    elif kind == "array set":
        env["arrays"] = {}
    elif kind == "scalar set":
        del env["scalars"]["lane"]
    elif kind == "scalar altered":
        env["scalars"]["e_max"] += 1
    elif kind == "plan fields":
        env["encode"]["bogus"] = 1
    elif kind == "encode plan":
        env["encode"]["e_max"] += 1
    elif kind == "decode plan":
        env["decode"]["fallback"] = "zero" if \
            env["decode"]["fallback"] == "membrane" else "membrane"
    # a tampered plan passes the fingerprint (it binds the scalars only)
    # and is caught by the plan/scalar consistency check, the last one
    return _dump(env), None


@pytest.mark.parametrize("kind", [
    "wrong artifact", "not json", "empty", "not an object", "format",
    "missing key", "array set", "scalar set", "scalar altered",
    "plan fields", "encode plan", "decode plan"])
def test_rejections_keep_jax_messages(arts, kind):
    """Each rejection path refuses with JAX's message, word for word, so the
    checks run in JAX's order."""
    art, jart = arts["mnist"]
    blob = serialize_program(lower(art, device=CPU, cache=False))
    bad, other = _tamper(kind, json.loads(blob), art, blob)
    if other is not None:
        art = Artifact(other[0], other[1])
        jart = JArtifact(other[0], other[1])
    with pytest.raises(ProgramIOError) as ei:
        deserialize_program(bad, art, device=CPU, cache=False)
    with pytest.raises(Exception) as ej:
        jdeserialize(bad, jart, cache=False)
    assert str(ei.value) == str(ej.value)
    with pytest.raises(TypeError):
        serialize_program({"not": "a program"})
    with pytest.raises(TypeError):
        deserialize_program(blob, {"not": "an artifact"}, device=CPU)


# ------------------------------------------------------- seed / peek keys
def test_seed_and_peek_are_keyed_by_the_resolved_device(arts, scoped_cache,
                                                        monkeypatch):
    """``lower(device="cuda")`` keys on ``"cuda:0"``: a program seeded or
    peeked under ``"cuda"`` must land on the same key, or the follower's
    engine would lower again. (The card is simulated: only the keys are
    under test.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    art, _ = arts["mnist"]
    fp = art.fingerprint()
    on_card = dataclasses.replace(lower(art, device=CPU, cache=False),
                                  device=torch.device("cuda", 0))
    assert scoped_cache.peek(fp, "cuda") is None
    assert scoped_cache.seed(fp, "cuda", on_card) is on_card
    assert list(scoped_cache._programs) == [(fp, "cuda:0")]
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        assert scoped_cache.peek(fp, dev) is on_card
    assert lower(art, device="cuda") is on_card      # a hit, never a lower
    st = scoped_cache.stats()
    assert st["program_misses"] == 0 and st["program_hits"] == 4
    assert scoped_cache.peek(fp, "cpu") is None
    with pytest.raises(ValueError, match="cannot seed a program on cuda:0"):
        scoped_cache.seed(fp, "cpu", on_card)


def test_seed_first_installer_wins_and_peek_never_lowers(arts, scoped_cache,
                                                         monkeypatch):
    art, _ = arts["mnist"]
    fp = art.fingerprint()

    def explode(*a):
        raise AssertionError("peek called _lower_uncached")

    with monkeypatch.context() as m:
        m.setattr(lowering, "_lower_uncached", explode)
        assert scoped_cache.peek(fp, CPU) is None
    resident = lower(art, device=CPU)
    blob = serialize_program(resident)
    assert deserialize_program(blob, art, device=CPU) is resident
    other = deserialize_program(blob, art, device=CPU, cache=False)
    assert other is not resident
    assert scoped_cache.seed(fp, CPU, other) is resident
    assert scoped_cache.stats()["programs"] == 1


def test_deserialize_seeds_the_active_cache(arts, scoped_cache):
    art, _ = arts["mnist"]
    blob = serialize_program(lower(art, device=CPU, cache=False))
    prog = deserialize_program(blob, art, device="cpu")
    assert scoped_cache.stats()["programs"] == 1
    assert lower(art, device="cpu") is prog
    assert scoped_cache.stats()["program_misses"] == 0


# --------------------------------------------------------------- broadcast
def test_follower_never_lowers(arts, scoped_cache, monkeypatch):
    art, _ = arts["mnist"]
    box: dict = {}
    leader = broadcast_program(art, leader=True, device=CPU,
                               publish=lambda b: box.update(blob=b))
    follower_cache = ProgramCache()
    prev = install(follower_cache)

    def explode(*a):
        raise AssertionError("follower called _lower_uncached")

    monkeypatch.setattr(lowering, "_lower_uncached", explode)
    try:
        got = broadcast_program(art, leader=False, device="cpu",
                                fetch=lambda: box["blob"])
    finally:
        install(prev)
    assert got.fingerprint == leader.fingerprint
    st = follower_cache.stats()
    assert st["programs"] == 1 and st["program_misses"] == 0
    with pytest.raises(ValueError, match="fetch"):
        broadcast_program(art, leader=False, device=CPU)


def test_leader_publishes_exactly_once_with_concurrent_followers(
        arts, scoped_cache):
    art, _ = arts["mnist"]
    published: list = []
    ready = threading.Event()

    def publish(blob):
        published.append(blob)
        ready.set()

    def fetch():
        assert ready.wait(timeout=30), "leader never published"
        return published[0]

    results: list = []
    followers = [threading.Thread(target=lambda: results.append(
        broadcast_program(art, leader=False, fetch=fetch, device=CPU)))
        for _ in range(4)]
    for t in followers:
        t.start()
    leader = broadcast_program(art, leader=True, publish=publish, device=CPU)
    for t in followers:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in followers)
    assert len(published) == 1, "leader must publish exactly once"
    assert len(results) == 4
    assert all(p.fingerprint == leader.fingerprint for p in results)


def test_prewarmed_follower_never_fetches(arts, scoped_cache):
    art, _ = arts["mnist"]
    resident = lower(art, device=CPU)

    def explode():
        raise AssertionError("pre-warmed follower called fetch()")

    assert broadcast_program(art, leader=False, fetch=explode,
                             device="cpu") is resident


def test_follower_fetch_failure_is_typed_not_a_hang(arts, scoped_cache):
    art, _ = arts["mnist"]

    def broken():
        raise ConnectionResetError("leader went away")

    with pytest.raises(ProgramBroadcastError) as ei:
        broadcast_program(art, leader=False, fetch=broken, device=CPU)
    assert ei.value.role == "follower"
    assert isinstance(ei.value.cause, ConnectionResetError)
    assert "leader went away" in str(ei.value)


def test_broadcast_over_shared_file(arts, scoped_cache, tmp_path):
    art, _ = arts["mnist"]
    path = str(tmp_path / "program.envelope.json")
    result: dict = {}
    follower_cache = ProgramCache()

    def follower():
        # the follower starts first and polls for the leader's file
        fetch = file_fetcher(path, timeout_s=10.0, poll_s=0.005)
        result["blob"] = fetch()

    t = threading.Thread(target=follower)
    t.start()
    leader = broadcast_program(art, leader=True, device=CPU,
                               publish=file_publisher(path))
    t.join(timeout=30)
    assert not t.is_alive()
    prev = install(follower_cache)
    try:
        got = broadcast_program(art, leader=False, device=CPU,
                                fetch=lambda: result["blob"])
    finally:
        install(prev)
    assert got.fingerprint == leader.fingerprint
    assert follower_cache.stats()["program_misses"] == 0


def test_file_fetcher_times_out(tmp_path):
    fetch = file_fetcher(str(tmp_path / "never.json"), timeout_s=0.05,
                         poll_s=0.01)
    with pytest.raises(TimeoutError, match="did the leader publish"):
        fetch()


# ------------------------------------------------------- the program-io oracle
@pytest.mark.parametrize("seed", PINNED_SEEDS)
def test_program_io_oracle_passes_like_jax(arts, seed):
    art, jart = arts[f"fuzz_seed{seed}"]
    got, want = _program_io_oracle(art, CPU), j_program_io(jart)
    assert got.passed and want.passed, got.detail
    assert (got.oracle, got.spec, got.stats) == \
        (want.oracle, want.spec, want.stats)
