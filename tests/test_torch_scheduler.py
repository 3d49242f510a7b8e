"""The port's continuous-batching scheduler on the CPU: batch formation
(size and deadline close), worker lanes, latency percentiles, the
result()/drain() APIs, the single-code-path overflow reroute and board
accounting — each case of the JAX package's ``tests/test_scheduler.py``
against the port with JAX's assertions, on the committed MNIST artifact —
plus what the port adds under threads: ``stats()`` carries JAX's keys and
``device``, each threaded lane serves on a stream of its own and waits on
it (not on the device), probes never advance a lane's fault injector, and
the kernels' launch counters lose no count under eight threads."""

import copy
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.artifact import Artifact as JArtifact
from repro.serving.scheduler import ServingScheduler as JScheduler
from repro_torch.core.artifact import Artifact
from repro_torch.core.reference import SNNReference
from repro_torch.data import mnist
from repro_torch.kernels import common
from repro_torch.kernels.event_accum import ops as ea
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.fused_event_lif import ops as fused
from repro_torch.kernels.lif import ops as lif
from repro_torch.kernels.spike_matmul import ops as smm
from repro_torch.kernels.ttfs_decode import ops as dec
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.scheduler import ServingError, ServingScheduler

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
MNIST_ART = os.path.join(ROOT, "src", "repro_torch", "assets",
                         "mnist_ttfs.npz")
CPU = "cpu"


@pytest.fixture(scope="module")
def art():
    return Artifact.load(MNIST_ART)


@pytest.fixture(scope="module")
def xte():
    return mnist.generate(64, 1235)[0]


@pytest.fixture(scope="module")
def want(art, xte):
    return SNNReference(art, device=CPU).forward(xte).labels.numpy()


def _event(art, **kw):
    return ServingScheduler(art, spec="accelerator-event", kernel="fused",
                            device=CPU, **kw)


def _tiny_emax_artifact(art: Artifact, e_max: int = 8) -> Artifact:
    clone = Artifact(copy.deepcopy(art.meta), dict(art.arrays))
    clone.meta["events"]["e_max"] = e_max
    return clone


def test_inline_mode_greedy_deterministic_batches(art, xte):
    s = _event(art, max_batch=4)
    rids = [s.submit(x) for x in xte[:10]]
    done = s.drain()
    assert sorted(done) == rids
    st = s.stats()
    assert st["batches"] == 3 and st["images_out"] == 10   # 4 + 4 + 2
    assert st["batch_fill_mean"] == pytest.approx(10 / 3)
    assert st["system_s"] >= st["accelerator_s"] > 0
    assert s.drain() == {}


def test_threaded_lanes_bitexact_with_reference(art, xte, want):
    with _event(art, workers=2, max_batch=8, max_wait_us=500.0) as s:
        rids = [s.submit(x) for x in xte[:48]]
        done = s.drain()
        got = np.asarray([done[r].label for r in rids])
        assert np.array_equal(got, want[:48])
        assert {done[r].lane for r in rids} <= {0, 1}
        st = s.stats()
        assert (0 < st["p50_latency_us"] <= st["p95_latency_us"]
                <= st["p99_latency_us"])
        assert st["queue_depth_peak"] >= 0
        assert st["images_out"] == 48


def test_deadline_closes_partial_batch(art, xte):
    with _event(art, workers=1, max_batch=64, max_wait_us=1000.0) as s:
        req = s.result(s.submit(xte[0]), timeout=120.0)
        assert req.label is not None and req.lane == 0
        st = s.stats()
        assert st["batches"] == 1
        assert st["batch_fill_mean"] <= 2
        assert st["max_wait_us"] == 1000.0


def test_closed_loop_result_api(art, xte, want):
    errs = []
    with _event(art, workers=2, max_batch=8, max_wait_us=500.0) as s:
        def client(c):
            for i in range(c, 24, 3):
                r = s.result(s.submit(xte[i]), timeout=120.0)
                if r.label != want[i]:
                    errs.append((i, r.label))
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        assert errs == []
        assert s.stats()["images_out"] == 24
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(xte[0])


def test_overflow_reroute_lives_in_scheduler(art, xte, want):
    tiny = _tiny_emax_artifact(art, e_max=8)
    with ServingScheduler(tiny, spec="accelerator-event", kernel="fused",
                          workers=1, max_batch=8, max_wait_us=500.0,
                          device=CPU) as s:
        rids = [s.submit(x) for x in xte[:24]]
        done = s.drain()
        got = np.asarray([done[r].label for r in rids])
        assert np.array_equal(got, want[:24])
        st = s.stats()
        assert st["overflow_fallbacks"] > 0
        assert any(done[r].fallback_dense for r in rids)


def test_board_accounting_and_denominators(art, xte, want):
    s = ServingScheduler(art, spec="board-batched", max_batch=16, device=CPU)
    st0 = s.stats()
    assert st0["accel_us_per_image"] == 0.0
    assert st0["board_model_us_per_image"] == 0.0
    assert st0["board_nj_per_image"] == 0.0
    rids = [s.submit(x) for x in xte[:20]]
    done = s.drain()
    assert np.array_equal(np.asarray([done[r].label for r in rids]),
                          want[:20])
    st = s.stats()
    assert st["board_cycles"] > 0 and st["board_nj_per_image"] > 0
    clock = s.lanes[0].runtime.cost.clock_hz
    assert st["board_model_us_per_image"] == pytest.approx(
        1e6 * st["board_cycles_per_image"] / clock)
    assert st["overflow_fallbacks"] == 0


def test_malformed_image_rejected_at_admission(art):
    s = _event(art, max_batch=4)
    with pytest.raises(ValueError, match="shape"):
        s.submit(np.zeros(3, np.float32))
    assert s.drain() == {}


def test_failed_batch_never_strands_waiters(art, xte):
    def boom(images, k, probe=False):
        raise RuntimeError("injected mid-batch explosion")

    with _event(art, workers=1, max_batch=4, max_wait_us=500.0,
                resilience={"max_retries": 0, "backoff_s": 0.001}) as s:
        s.lanes[0].serve = boom
        rid = s.submit(xte[0])
        with pytest.raises(ServingError, match="explosion") as ei:
            s.result(rid, timeout=120.0)
        req = ei.value.request
        assert req.rid == rid and req.label is None
        assert "injected mid-batch explosion" in req.error
        st = s.stats()
        assert st["errors"] == 1 and st["lane_faults"] >= 1
        ok = s.result(s.submit(xte[0]), timeout=120.0)
        assert ok.error is None and ok.label is not None
        assert s.stats()["lane_restarts"] >= 1

    s2 = _event(art, max_batch=4)
    s2.lanes[0].serve = boom
    rid2 = s2.submit(xte[0])
    with pytest.raises(RuntimeError, match="explosion"):
        s2.drain()
    done = s2.drain()
    assert done[rid2].error is not None and s2.stats()["errors"] == 1


def test_drain_does_not_steal_claimed_result(art, xte):
    """A ``result()`` waiter's claim holds against a concurrent ``drain()``.
    The lane serves the request only once the claim has been seen: a claim
    lasts only until its request completes, so a lane left to serve at once
    could complete it between two polls and the claim would never show."""
    with _event(art, workers=1, max_batch=4, max_wait_us=500.0) as s:
        release = threading.Event()
        serve = s.lanes[0].serve

        def held(images, k, probe=False):
            if not probe:
                assert release.wait(timeout=120.0)
            return serve(images, k, probe=probe)

        s.lanes[0].serve = held
        got = {}
        rid = s.submit(xte[0])
        t = threading.Thread(
            target=lambda: got.update(r=s.result(rid, timeout=120.0)))
        t.start()
        deadline = time.time() + 30
        while rid not in s._claims:
            assert time.time() < deadline
            time.sleep(0.001)
        release.set()
        drained = s.drain()
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert got["r"].rid == rid and got["r"].label is not None
        assert rid not in drained


def test_close_fails_backlog_instead_of_draining_it(art, xte):
    s = _event(art, workers=1, max_batch=4, max_wait_us=10_000_000.0)
    rids = [s.submit(x) for x in xte[:64]]
    s.close()
    done = s.drain()
    assert sorted(done) == rids
    failed = [r for r in done.values() if r.error == "scheduler closed"]
    served = [r for r in done.values() if r.error is None]
    assert len(failed) + len(served) == 64 and failed


def test_result_unknown_or_already_claimed_rid_raises(art, xte):
    s = _event(art, max_batch=4)
    with pytest.raises(KeyError):
        s.result(999)
    rid = s.result(s.submit(xte[0]), timeout=120.0).rid
    with pytest.raises(KeyError):
        s.result(rid)
    rid2 = s.submit(xte[1])
    s.drain()
    with pytest.raises(KeyError):
        s.result(rid2)


def test_stats_snapshot_consistent_under_concurrent_chaos(art, xte):
    n, n_threads = 48, 3
    s = _event(art, workers=2, max_batch=8, max_wait_us=500.0,
               faults="crash=0,seed=12", resilience={"backoff_s": 0.001})
    submitted = []
    sub_lock = threading.Lock()
    stop = threading.Event()
    violations: list[str] = []

    def submitter(k):
        for i in range(k, n, n_threads):
            rid = s.submit(xte[i % len(xte)])
            with sub_lock:
                submitted.append(rid)

    def reader():
        monotone = ("images_out", "batches", "requeued", "lane_faults",
                    "lane_restarts", "errors")
        last = {k: 0 for k in monotone}
        while not stop.is_set():
            st = s.stats()
            with sub_lock:
                n_sub = len(submitted)
            if st["images_out"] > n_sub:
                violations.append(f"torn read: images_out "
                                  f"{st['images_out']} > submitted {n_sub}")
            for k in monotone:
                if st[k] < last[k]:
                    violations.append(f"counter {k} went backwards: "
                                      f"{st[k]} < {last[k]}")
                last[k] = st[k]
            if st["batches"] and st["images_out"] < st["batches"]:
                violations.append("more batches than completed images")

    with s:
        readers = [threading.Thread(target=reader) for _ in range(2)]
        subs = [threading.Thread(target=submitter, args=(k,))
                for k in range(n_threads)]
        for t in readers + subs:
            t.start()
        for t in subs:
            t.join(timeout=120.0)
        done = s.drain()
        stop.set()
        for t in readers:
            t.join(timeout=30.0)
        st = s.stats()
    assert not violations, violations[:5]
    assert sorted(done) == sorted(submitted)
    assert st["images_out"] == n and st["lane_faults"] >= 1
    assert all(r.error is None for r in done.values())


# ------------------------------------------------------ what the port adds
def test_stats_keys_equal_jax_plus_device(art):
    jart = JArtifact.load(MNIST_ART)
    for spec, kw, jkw in (("accelerator-event", {"kernel": "fused"},
                           {"kernel": "jnp"}),
                          ("board-batched", {}, {})):
        got = ServingScheduler(art, spec=spec, device=CPU, **kw).stats()
        want = JScheduler(jart, spec=spec, **jkw).stats()
        assert list(got) == ["spec", "device"] + [k for k in want
                                                  if k != "spec"]
        assert got["device"] == "cpu"
        assert {k: got[k] for k in ("workers", "max_batch", "max_wait_us",
                                    "lane_health")} == {
            k: want[k] for k in ("workers", "max_batch", "max_wait_us",
                                 "lane_health")}


class _FakeStream:
    """Stands in for ``torch.cuda.Stream`` on the CPU: records who waits
    on it."""

    def __init__(self, lane_threads: dict):
        self.syncs = 0
        self.lane_threads = lane_threads

    def synchronize(self):
        self.syncs += 1


def test_threaded_lanes_serve_on_their_own_streams(art, xte, want,
                                                   monkeypatch):
    """Each threaded lane gets a stream of its own (a replacement gets a
    new one), serves every batch with it current on its own thread, and
    ends its accelerator scope on it, never on the whole device; the inline
    lane stays on the caller's stream."""
    current = threading.local()
    entered: dict[int, set] = {}
    made: list[_FakeStream] = []

    def new_stream(device):
        made.append(_FakeStream(entered))
        return made[-1]

    class StreamCtx:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            self.prev = getattr(current, "stream", None)
            current.stream = self.stream
            entered.setdefault(id(self.stream), set()).add(
                threading.current_thread().name)

        def __exit__(self, *exc):
            current.stream = self.prev

    def device_sync(*_):
        raise AssertionError("a threaded lane synchronized the device")

    monkeypatch.setattr(sched_mod, "_lane_stream", new_stream)
    monkeypatch.setattr(torch.cuda, "stream", StreamCtx)
    monkeypatch.setattr(torch.cuda, "synchronize", device_sync)
    with _event(art, workers=2, max_batch=8, max_wait_us=500.0,
                faults="crash=0,lanes=1,seed=5",
                resilience={"backoff_s": 0.001}) as s:
        rids = [s.submit(x) for x in xte[:32]]
        done = s.drain()
        lanes = list(s.lanes)
    assert np.array_equal([done[r].label for r in rids], want[:32])
    # two lanes at commission, one rebuild of lane 1 after its crash
    assert len(made) == 3 and len({id(m) for m in made}) == 3
    assert [lane.stream for lane in lanes] == [made[0], made[2]]
    for m in made:
        assert m.syncs >= 2                  # built + warmed on it
    served = [entered.get(id(m), set()) for m in made]
    assert served[0] == {"MainThread", "serve-lane-0"}
    # lane 1's first batch crashed in its injector, before any launch; its
    # rebuild was built, warmed and served on lane 1's own thread
    assert served[1] == {"MainThread"}
    assert served[2] == {"serve-lane-1"}
    # the inline lane: no stream of its own
    inline = _event(art, max_batch=8)
    assert inline.lanes[0].stream is None and len(made) == 3


def test_probes_do_not_advance_the_injector(art, xte, want):
    """Warm-up and canary traffic are probes: ``crash=0`` crashes the first
    real batch, not the warm-up, and the canary check at commission leaves
    the batch clock at 0."""
    s = _event(art, workers=1, max_batch=8, max_wait_us=500.0,
               faults="crash=0,seed=3", canary_pool=xte[:16],
               resilience={"backoff_s": 0.001})
    try:
        lane = s.lanes[0]
        assert lane.injector is not None and lane.injector.batches == 0
        assert s.stats()["canary_checks"] == 1
        rids = [s.submit(x) for x in xte[:8]]
        done = s.drain()
        st = s.stats()
    finally:
        s.close()
    assert lane.injector.crashes == 1 and lane.injector.batches == 1
    assert st["lane_faults"] == 1 and st["errors"] == 0
    assert np.array_equal([done[r].label for r in rids], want[:8])


def test_launch_counts_exact_under_threads():
    """Eight threads each count 10,000 launches on every wrapper's counters
    at once, with the interpreter switching threads as often as it can: no
    count is lost."""
    counters = [(m.LAUNCHES, name) for m in (fused, ea, lif, smm, dec, fa)
                for name in m.LAUNCHES]
    counters += [(smm.ROUTES, "tma"), (dec.ROUTES, "warp")]
    before = {(id(c), n): c[n] for c, n in counters}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(10_000):
                for c, n in counters:
                    common.count_launch(c, n)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for c, n in counters:
        assert c[n] - before[(id(c), n)] == 80_000, n
    for m in (fused, ea, lif, smm, dec, fa):
        m.reset_launches()


def _fail_launch(*args, **kw):
    raise common.KernelError("fused_event_lif_decode launch failed with "
                             "CUDA error 1")


def _fail_inside(*args, **kw):
    raise TypeError("'Tensor' object is not callable")


@pytest.mark.parametrize("where", ["launch", "inside the wrapper"])
def test_kernel_failure_raises_and_is_never_served_around(art, xte, where,
                                                          monkeypatch):
    """A kernel that fails (a launch the CUDA entry refuses, or an error
    raised inside the wrapper, such as a shadowed name) is not a lane fault:
    commissioning raises, a lane in service fails its batch and the queue
    with an explicit error and halts the scheduler (``submit`` raises), and
    no lane is rebuilt, quarantined or degraded to the dense path."""
    if where == "launch":
        target, err = (fused, "fused_event_lif_decode", _fail_launch), \
            common.KernelError
    else:
        target, err = (fused._ref, "fused_event_lif_decode_ref",
                       _fail_inside), TypeError
    for workers in (0, 1):
        with monkeypatch.context() as m:
            m.setattr(*target)
            with pytest.raises(err):
                _event(art, workers=workers, max_batch=8)
        s = _event(art, workers=workers, max_batch=8,
                   resilience={"backoff_s": 0.001, "verify": True})
        with monkeypatch.context() as m:
            m.setattr(*target)
            rids = [s.submit(x) for x in xte[:12]]
            if workers:
                done = s.drain()
            else:
                with pytest.raises(err):
                    s.drain()                 # inline: the caller sees it
                done = s.drain()
        assert sorted(done) == rids
        for r in done.values():
            assert r.label is None and not r.fallback_dense
            assert r.error.startswith(f"kernel failure: {err.__name__}")
        with pytest.raises(RuntimeError, match="halted") as e:
            s.submit(xte[0])
        assert isinstance(e.value.__cause__, err)
        st = s.stats()
        assert st["errors"] == 12 and st["images_out"] == 0
        for key in ("lane_faults", "requeued", "lane_restarts",
                    "quarantines", "breaker_degraded"):
            assert st[key] == 0, key
        assert st["lane_health"] == ["healthy"]
        s.close()
