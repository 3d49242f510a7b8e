"""The port's board emulator against the JAX package on the CPU: every board
spec (``board-batched-cuda`` on its kernel's plain version) against the
golden conformance seeds, the port's per-image scheduler and batched path
against JAX's on the served MNIST artifact in both modes and with the FIFO
stalling (E_max 8), their span trees, the board serving engine's stats, the
registry's advertise/construct contract, and the unit rules of the AER
queue, the cost account and the neuron core."""

import copy
import io
import os

import numpy as np
import pytest
import torch

from repro.board import SNNBoard as JSNNBoard
from repro.board import energy as jenergy
from repro.core.artifact import Artifact as JArtifact
from repro.core.runtimes import make_runtime as jmake_runtime
from repro.faults import FaultPlan as JFaultPlan
from repro.serving.snn_engine import SNNServeEngine as JEngine
from repro.telemetry import trace as jtrace
from repro_torch.board import (AEREventQueue, GroupedNeuronCore, SNNBoard,
                               SNNBoardBatched)
from repro_torch.board.energy import account, span_attrs, stack_traces
from repro_torch.core import runtimes
from repro_torch.core.artifact import Artifact
from repro_torch.core.hw import PYNQ_COST, BoardCostModel
from repro_torch.core.lowering import lower
from repro_torch.core.runtimes import (ADVERTISED_SPECS, make_runtime,
                                       registry_consistency_errors)
from repro_torch.data import mnist
from repro_torch.faults import FaultPlan
from repro_torch.serving.snn_engine import SNNServeEngine
from repro_torch.telemetry import trace as ttrace

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MNIST_ART = os.path.join(ASSETS, "mnist_ttfs.npz")
OUTPUTS = ("labels", "first_spike", "v_final", "steps")
TRACE = ("ticks", "events", "stalls", "synops", "cycles", "energy_nj")
#: golden key -> trace field
GOLDEN_TRACE = {"board_cycles": "cycles", "board_events": "events",
                "board_stalls": "stalls", "board_energy_nj": "energy_nj"}
BOARD_SPECS = tuple(s for s in ADVERTISED_SPECS if s.startswith("board"))
BOARD_STATS = ("board_cycles", "board_stalls", "board_cycles_per_image",
               "board_model_us_per_image", "board_nj_per_image")


def fuzz_case(seed: int):
    with np.load(os.path.join(ASSETS, f"fuzz_seed{seed}.npz")) as z:
        art = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
        images = z["images"]
    with np.load(os.path.join(GOLDEN, f"conformance_seed{seed}.npz")) as g:
        golden = {k: g[k] for k in g.files}
    return art, images, golden


def with_e_max(art, e_max: int):
    """A copy of ``art`` (either package's Artifact) with events.e_max set."""
    meta = copy.deepcopy(art.meta)
    meta["events"]["e_max"] = e_max
    return type(art)(meta, dict(art.arrays))


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_run(got, got_rt, want, want_rt, what):
    """Every output, every trace field (dtypes included) and the per-tick
    event counts equal. The per-image scheduler records the ticks it ran,
    the batched path all T, so only runs of one kind are compared."""
    for key in OUTPUTS:
        g, w = host(getattr(got, key)), host(getattr(want, key))
        assert g.dtype == w.dtype and np.array_equal(g, w), (what, key)
    for field in TRACE:
        g = getattr(got_rt.last_trace, field)
        w = getattr(want_rt.last_trace, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), (what, field)
    assert np.array_equal(got_rt.last_tick_counts, want_rt.last_tick_counts), \
        (what, "tick counts")


@pytest.fixture(scope="module")
def served_images():
    x, _ = mnist.generate(256, 1235)       # the first 256 test images
    return x


@pytest.mark.parametrize("seed", range(8))
def test_board_specs_match_golden(seed):
    art, images, golden = fuzz_case(seed)
    assert set(BOARD_SPECS) == {"board", "board-batched", "board-batched-torch",
                                "board-batched-cuda", "board-py"}
    for spec in BOARD_SPECS:
        rt = make_runtime(art, spec, device="cpu")
        out = rt.forward(images)
        for key in OUTPUTS:
            assert np.array_equal(getattr(out, key).numpy(), golden[key]), \
                (spec, key)
        for key, field in GOLDEN_TRACE.items():
            got = getattr(rt.last_trace, field)
            assert got.dtype == golden[key].dtype, (spec, key)
            assert np.array_equal(got, golden[key]), (spec, key)


@pytest.mark.parametrize("e_max", [None, 8], ids=["e_max", "e_max8"])
@pytest.mark.parametrize("latency_mode", [False, True],
                         ids=["full-T", "latency"])
def test_board_matches_jax_on_mnist(served_images, latency_mode, e_max):
    """The port's board-py and board-batched (both kernels) against JAX's
    board-py and board-batched-jnp on the first 256 test images: every
    output, every trace field, the per-tick event counts."""
    jart, art = JArtifact.load(MNIST_ART), Artifact.load(MNIST_ART)
    if e_max is not None:
        jart, art = with_e_max(jart, e_max), with_e_max(art, e_max)
    want = {}
    for spec in ("board-py", "board-batched-jnp"):
        rt = jmake_runtime(jart, spec, latency_mode=latency_mode)
        want[spec] = (rt.forward(served_images), rt)
    for spec, jax_spec in (("board-py", "board-py"),
                           ("board-batched", "board-batched-jnp"),
                           ("board-batched-cuda", "board-batched-jnp")):
        rt = make_runtime(art, spec, latency_mode=latency_mode, device="cpu")
        assert_same_run(rt.forward(served_images), rt, *want[jax_spec], spec)
    want_rt = want["board-batched-jnp"][1]
    stalls = int(want_rt.last_trace.stalls.sum())
    assert stalls > 0 if e_max == 8 else stalls == 0


def test_board_cuda_route_matches_jax_pallas():
    """JAX's board-batched-pallas (its LIF on the Pallas kernel, interpret
    mode) against the port's board-batched-cuda on the kernel's plain
    version, on 24 images, with the FIFO stalling."""
    x, _ = mnist.generate(24, 1235)
    jart = with_e_max(JArtifact.load(MNIST_ART), 8)
    want_rt = jmake_runtime(jart, "board-batched-pallas")
    want = want_rt.forward(x)
    rt = make_runtime(with_e_max(Artifact.load(MNIST_ART), 8),
                      "board-batched-cuda", device="cpu")
    assert_same_run(rt.forward(x), rt, want, want_rt, "cuda vs pallas")
    assert int(rt.last_trace.stalls.sum()) > 0


def _canonical(tracer_mod, make, images):
    t = tracer_mod.Tracer()
    prev = tracer_mod.install(t)
    try:
        make().forward(images)
    finally:
        tracer_mod.install(prev)
    return t


@pytest.mark.parametrize("spec", ["board-py", "board-batched"])
def test_board_span_trees_equal_jax(served_images, spec):
    x = served_images[:4]
    want = _canonical(jtrace, lambda: jmake_runtime(
        JArtifact.load(MNIST_ART), spec), x)
    got = _canonical(ttrace, lambda: make_runtime(
        Artifact.load(MNIST_ART), spec, device="cpu"), x)
    assert got.canonical() == want.canonical()
    assert got.fingerprint() == want.fingerprint()
    assert len(got.find("board.image")) == 4
    impl = {s.meta.get("impl") for s in got.sorted_spans()
            if s.name == "board.forward"}
    assert impl == {"board-py" if spec == "board-py" else "board-batched"}


@pytest.mark.parametrize("e_max", [None, 8], ids=["e_max", "e_max8"])
def test_board_engine_matches_jax_engine(served_images, e_max):
    """SNNServeEngine(backend="board") on 256 images at max_batch 48 (a
    padded last batch): the labels and every board_* stat equal the JAX
    board engine's; the board never reroutes."""
    results = []
    for load, engine, kw in ((JArtifact.load, JEngine, {}),
                             (Artifact.load, SNNServeEngine,
                              {"device": "cpu"})):
        art = load(MNIST_ART)
        if e_max is not None:
            art = with_e_max(art, e_max)
        eng = engine(art, max_batch=48, backend="board", **kw)
        for img in served_images:
            eng.submit(img)
        done = eng.flush()
        reqs = [done[r] for r in sorted(done)]
        st = eng.stats()
        eng.close()
        results.append(([r.label for r in reqs], [r.steps for r in reqs],
                         {k: st[k] for k in BOARD_STATS},
                         st["overflow_fallbacks"], st["images_out"]))
    assert results[1] == results[0]
    assert results[1][3] == 0 and results[1][4] == 256
    assert results[1][2]["board_model_us_per_image"] == pytest.approx(
        1e6 * results[1][2]["board_cycles_per_image"] / PYNQ_COST.clock_hz)
    assert (results[1][2]["board_stalls"] > 0) == (e_max == 8)


def test_board_engine_kernels_and_refusals(served_images):
    """Both kernels serve the same labels and board stats in each mode; the
    default kernel is torch; the JAX kernel names and the accelerator's
    fused kernel are refused."""
    art = Artifact.load(MNIST_ART)
    x = served_images[:64]
    assert SNNServeEngine(art, backend="board",
                          device="cpu").accel.kernel == "torch"
    for latency in (False, True):
        served = []
        for kernel in ("torch", "cuda"):
            eng = SNNServeEngine(art, backend="board", kernel=kernel,
                                 latency_mode=latency, device="cpu")
            assert eng.accel.kernel == kernel
            labels = eng.classify(x)
            st = eng.stats()
            served.append((labels.tolist(),
                           {k: st[k] for k in BOARD_STATS}))
        assert served[0] == served[1]
    # the JAX package's kernel names and the accelerator's own fail loudly
    for kernel in ("fused", "jnp", "pallas", "bogus"):
        with pytest.raises(ValueError, match="board kernel"):
            SNNServeEngine(art, backend="board", kernel=kernel, device="cpu")
    # no board_* keys on the accelerator
    assert not any(k.startswith("board_") for k in
                   SNNServeEngine(art, device="cpu").stats())
    # a dynamic fault plan reaches the host tick loop, as in JAX: a forced
    # FIFO depth, a stuck group and a glitching AER link
    plan = "fifo=2,stuck=1,aer_drop=0.1,seed=3"
    board = SNNBoard(art, faults=FaultPlan.parse(plan), device="cpu")
    jboard = JSNNBoard(JArtifact.load(MNIST_ART),
                       faults=JFaultPlan.parse(plan))
    out, jout = board.forward(x[:8]), jboard.forward(x[:8])
    for key in ("labels", "first_spike", "v_final", "steps"):
        assert np.array_equal(getattr(out, key).numpy(),
                              np.asarray(getattr(jout, key))), key
    assert board.depth == jboard.depth == 2
    assert board.stuck_groups == jboard.stuck_groups != []
    for key in ("last_tick_counts", "last_ecc"):
        assert np.array_equal(getattr(board, key), getattr(jboard, key))


def test_registry_is_consistent():
    art, _, _ = fuzz_case(0)
    assert registry_consistency_errors(art, device="cpu") == []
    assert runtimes.available() == ["accelerator", "board", "reference"]
    for spec in ("board-batched-fused", "board-batched-pallas",
                 "board-batched-jnp", "board-py-torch", "board-bogus"):
        with pytest.raises(ValueError):
            make_runtime(art, spec, device="cpu")


def test_registry_reports_an_unadvertised_spec(monkeypatch):
    """The contract's other direction: a spelling that constructs without
    being advertised is reported."""
    art, _, _ = fuzz_case(1)
    monkeypatch.setattr(runtimes, "ADVERTISED_SPECS", tuple(
        s for s in ADVERTISED_SPECS if s != "board-batched-cuda"))
    assert registry_consistency_errors(art, device="cpu") == [
        "spec 'board-batched-cuda' constructs but is not advertised"]


def test_board_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = Artifact.load(MNIST_ART)
    for make in (lambda: SNNBoard(art), lambda: SNNBoardBatched(art),
                 lambda: make_runtime(art, "board-batched-cuda"),
                 lambda: SNNServeEngine(art, backend="board")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_aer_queue_schedule_and_backpressure():
    T = 4
    times = np.array([0, 2, 0, 3, 4, 1, 0], np.int32)   # time 4 == never (T)
    q = AEREventQueue(times, T, depth=2)
    assert q.total_events == 6
    assert np.array_equal(q.events_at(0), [0, 2, 6])    # ascending ids
    assert np.array_equal(q.events_at(1), [5])
    assert np.array_equal(q.events_at(2), [1])
    assert np.array_equal(q.events_at(3), [3])
    assert np.array_equal(q.counts(), [3, 1, 1, 1])
    # 3 events into a depth-2 FIFO: 1 stall; no events are ever dropped
    assert q.stalls_at(0) == 1 and q.stalls_at(1) == 0
    assert sum(len(ids) for _, ids in q) == q.total_events
    with pytest.raises(ValueError, match="one image"):
        AEREventQueue(times[None], T, depth=2)


def test_cost_model_account_terms_and_floor():
    cost = BoardCostModel()
    tr = account(events=10, ticks=5, stalls=2, n_pad=256, cost=cost)
    assert int(tr.cycles) == (cost.cycles_fixed + 10 * cost.cycles_per_event
                              + 5 * cost.cycles_per_tick
                              + 2 * cost.cycles_per_stall + cost.cycles_decode)
    assert int(tr.synops) == 10 * 256
    expect_nj = (10 * cost.pj_per_event + 10 * 256 * cost.pj_per_synop
                 + 5 * 256 * cost.pj_per_neuron_tick + cost.pj_per_decode) / 1e3
    assert float(tr.energy_nj) == pytest.approx(expect_nj)
    # zero-work floor is the paper-calibrated service overhead
    floor = account(events=0, ticks=0, stalls=0, n_pad=256, cost=cost)
    assert int(floor.cycles) == cost.cycles_fixed + cost.cycles_decode == 11
    assert floor.us() == pytest.approx(0.1375)


def test_account_equals_jax_bit_for_bit():
    """The same int64/float64 expression as JAX's (``* 1e-3``, not
    ``/ 1000``), on random batches: every field, dtypes included, and the
    span attributes and stacked per-image traces built from it."""
    rng = np.random.RandomState(0)
    events = rng.randint(0, 5000, 512)
    ticks = rng.randint(0, 33, 512)
    stalls = rng.randint(0, 900, 512)
    for n_pad in (128, 256, 2048):
        got = account(events, ticks, stalls, n_pad)
        want = jenergy.account(events, ticks, stalls, n_pad)
        for field in TRACE:
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype and np.array_equal(g, w), field
        assert span_attrs(got) == jenergy.span_attrs(want)
        per = [account(int(e), int(t), int(s), n_pad)
               for e, t, s in zip(events[:16], ticks[:16], stalls[:16])]
        stacked = stack_traces(per)
        for field in TRACE:
            assert np.array_equal(getattr(stacked, field),
                                  getattr(got, field)[:16]), field
        assert got.summary() == want.summary()


def test_neuron_core_rejects_oversized_network():
    cost = PYNQ_COST
    n_pad = cost.neurons_direct + cost.lane          # one group too many
    w = np.zeros((8, n_pad), np.int8)
    thr = np.ones((n_pad,), np.int32)
    with pytest.raises(ValueError, match="directly addressable"):
        GroupedNeuronCore(w, thr, leak_shift=4, T=8, cost=cost)
    with pytest.raises(ValueError, match="lane width"):
        GroupedNeuronCore(w[:, :130], thr[:130], leak_shift=4, T=8)


def test_neuron_core_owns_its_copies_and_shifts_arithmetically():
    """The core's state is host int32 and its weights/thresholds are its
    own: writing ``core.thr`` leaves the program untouched. leak_shift 31
    leaks +1 a tick on a negative membrane (``v >> 31 == -1``)."""
    prog = lower(Artifact.load(MNIST_ART), device="cpu")
    core = GroupedNeuronCore.from_program(prog)
    before = prog.thr_padded.clone()
    core.thr[:] = 0
    assert torch.equal(prog.thr_padded, before)
    assert core.v.dtype == np.int32 and core.first.dtype == np.int32
    w = np.full((1, 128), -5, np.int8)
    core = GroupedNeuronCore(w, np.full(128, 1000, np.int32), leak_shift=31,
                             T=4)
    core.dispatch(0)
    core.tick(0)                                    # v = -5
    core.tick(1)                                    # v = -5 - (-1) = -4
    assert np.all(core.v_flat == -4)
    assert np.all(core.first_flat == 4)
