"""The port's fault subsystem (``repro_torch.faults``) against the JAX
package's on the CPU, tolerance 0 (every path here is integer): the plan
grammar, lifecycle and seeded streams, ``corrupt_artifact`` byte for byte,
the AER/membrane/stuck-at injectors and ``board-py`` under every dynamic
plan (outputs, trace, tick histogram, ``last_ecc``), the static/dynamic
``make_runtime`` rules with JAX's messages, the checksum, canary, trace and
ECC detectors, and the committed ``faults_expected.npz`` equal to a fresh
JAX export. Each case of the JAX package's ``tests/test_faults.py`` runs
here against the port with JAX's assertions, on the committed MNIST and
fuzz artifacts."""

import copy
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from repro.core.artifact import Artifact as JArtifact
from repro.core.runtimes import make_runtime as jmake_runtime
from repro.faults import Canary as JCanary
from repro.faults import FaultPlan as JFaultPlan
from repro.faults import FaultyAEREventQueue as JFaultyQueue
from repro.faults import corrupt_artifact as jcorrupt
from repro.faults import ecc_errors as jecc_errors
from repro.faults import trace_errors as jtrace_errors
from repro.faults import plan as jplan
from repro.faults.models import MembraneUpsetInjector as JUpset
from repro.board.neuron_core import GroupedNeuronCore as JCore
from repro_torch.board.event_queue import AEREventQueue
from repro_torch.board.neuron_core import GroupedNeuronCore
from repro_torch.core import lowering
from repro_torch.core.artifact import Artifact
from repro_torch.core.hw import PYNQ_COST
from repro_torch.core.lowering import lower, lower_with_faults
from repro_torch.core.quant import INT32_NEVER_FIRE
from repro_torch.core.runtimes import make_runtime
from repro_torch.data import mnist
from repro_torch.faults import (Canary, FaultPlan, FaultyAEREventQueue,
                                MembraneUpsetInjector, apply_stuck,
                                corrupt_artifact, ecc_errors,
                                integrity_errors, trace_errors)
from repro_torch.faults.plan import DYNAMIC_FIELDS, LANE_FIELDS, STATIC_FIELDS

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
GOLDEN = os.path.join(ROOT, "tests", "golden")
MNIST_ART = os.path.join(ASSETS, "mnist_ttfs.npz")
CASES = ("mnist",) + tuple(f"fuzz{s}" for s in range(8))
OUTPUTS = ("labels", "first_spike", "v_final", "steps")


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_fixture",
        os.path.join(ROOT, "scripts", "export_torch_fixture.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


SCRIPT = _load_script()


def _both(case: str):
    """(port artifact, JAX artifact, images, canary pool) of one case, as
    the exporter builds them."""
    if case == "mnist":
        x = mnist.generate(10_000, 1235)[0][:SCRIPT.BOARD_PY_IMAGES]
        return Artifact.load(MNIST_ART), JArtifact.load(MNIST_ART), x, x
    with np.load(os.path.join(ASSETS, f"fuzz_seed{case[4:]}.npz")) as z:
        raw, images = z["artifact"].tobytes(), z["images"]
    return (Artifact.load(io.BytesIO(raw)), JArtifact.load(io.BytesIO(raw)),
            images, images)


@pytest.fixture(scope="module")
def cases():
    return {case: _both(case) for case in CASES}


@pytest.fixture(scope="module")
def fuzz0(cases):
    return cases["fuzz0"]


@pytest.fixture(scope="module")
def expected():
    with np.load(os.path.join(ASSETS, "faults_expected.npz")) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------- plan
def test_plan_parse_grammar():
    p = FaultPlan.parse("seu_weight=4,aer_drop=0.02,crash=0:2,seed=7")
    assert p.seu_weight_flips == 4 and p.aer_drop_rate == 0.02
    assert p.crash_batches == (0, 2) and p.seed == 7
    assert p.has_static and p.has_dynamic and p.has_lane_faults
    assert FaultPlan.parse("").is_clean
    assert FaultPlan.parse("fifo=4").fifo_depth == 4
    assert FaultPlan.parse("persistent=true,stuck=1").persistent
    for bad, msg in (("bogus=1", "unknown fault-plan key"),
                     ("seu_weight", "needs '=value'")):
        with pytest.raises(ValueError, match=msg) as got:
            FaultPlan.parse(bad)
        with pytest.raises(ValueError) as want:
            JFaultPlan.parse(bad)
        assert str(got.value) == str(want.value)
    assert (DYNAMIC_FIELDS, STATIC_FIELDS, LANE_FIELDS) == (
        jplan.DYNAMIC_FIELDS, jplan.STATIC_FIELDS, jplan.LANE_FIELDS)


def test_plan_coerce_and_lifecycle():
    p = FaultPlan(seed=3, crash_batches=(0,), lanes=(1,))
    assert FaultPlan.coerce(p) is p
    assert FaultPlan.coerce(None) is None
    assert FaultPlan.coerce({"seed": 2}).seed == 2
    assert FaultPlan.coerce("seu_thr=1").seu_threshold_flips == 1
    with pytest.raises(TypeError):
        FaultPlan.coerce(42)
    assert p.for_lane(0).is_clean
    assert p.for_lane(1).crash_batches == (0,)
    assert p.for_lane(1).seed != p.seed
    assert p.after_scrub().is_clean
    pp = FaultPlan(seu_weight_flips=2, persistent=True)
    assert pp.after_scrub() is pp


def test_plan_rng_deterministic_and_stream_decorrelated():
    a = FaultPlan(seed=5).rng("aer", 0).randint(1 << 30, size=8)
    b = FaultPlan(seed=5).rng("aer", 0).randint(1 << 30, size=8)
    c = FaultPlan(seed=5).rng("aer", 1).randint(1 << 30, size=8)
    d = FaultPlan(seed=6).rng("aer", 0).randint(1 << 30, size=8)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert np.array_equal(a, JFaultPlan(seed=5).rng("aer", 0).randint(
        1 << 30, size=8))


def test_plans_equal_jax_and_the_committed_asset(expected, monkeypatch):
    """Parse, describe, lane split, scrub and the first draws of every
    seeded stream, spec by spec: the port's equal JAX's, and both equal
    the committed asset (what the card checks against)."""
    want = json.loads(str(expected["plans_json"]))
    assert [r["spec"] for r in want] == list(SCRIPT.PLAN_SPECS)
    monkeypatch.setattr(SCRIPT, "FaultPlan", FaultPlan)
    got = [SCRIPT.plan_record(s) for s in SCRIPT.PLAN_SPECS]
    assert json.loads(json.dumps(got, sort_keys=True)) == want


# -------------------------------------------------------------- artifact SEU
def test_corrupt_artifact_detected_and_original_pristine(fuzz0):
    art = fuzz0[0]
    before = {k: v.copy() for k, v in art.arrays.items()}
    plan = FaultPlan(seed=9, seu_weight_flips=3, seu_threshold_flips=1)
    bad = corrupt_artifact(art, plan)
    assert integrity_errors(bad)
    bad2 = corrupt_artifact(art, plan)
    for k in bad.arrays:
        assert np.array_equal(bad.arrays[k], bad2.arrays[k])
    for k, v in before.items():
        assert np.array_equal(art.arrays[k], v)
    assert integrity_errors(art) == []
    assert corrupt_artifact(art, FaultPlan.none()) is art
    # an in-memory artifact that was never exported: the manifest is stamped
    # from the pristine arrays first, as JAX does
    raw = Artifact({k: v for k, v in art.meta.items()
                    if k not in ("manifest", "fingerprint")},
                   dict(art.arrays))
    jraw = JArtifact(copy.deepcopy(raw.meta), dict(raw.arrays))
    got, want = corrupt_artifact(raw, plan), jcorrupt(jraw, JFaultPlan(
        seed=9, seu_weight_flips=3, seu_threshold_flips=1))
    assert got.meta == want.meta and got.fingerprint() == want.fingerprint()
    assert integrity_errors(got)


@pytest.mark.parametrize("case", CASES)
def test_corrupt_artifact_equals_jax_byte_for_byte(cases, expected, case):
    art, jart, _, _ = cases[case]
    for i, spec in enumerate(SCRIPT.STATIC_PLANS):
        got = corrupt_artifact(art, FaultPlan.parse(spec))
        want = jcorrupt(jart, JFaultPlan.parse(spec))
        key = f"corrupt_{case}_{i}"
        assert set(got.arrays) == set(want.arrays)
        for name, a in got.arrays.items():
            assert a.dtype == want.arrays[name].dtype
            assert a.tobytes() == want.arrays[name].tobytes(), (spec, name)
            idx = np.nonzero(art.arrays[name].reshape(-1)
                             != a.reshape(-1))[0]
            if idx.size:
                assert np.array_equal(idx, expected[f"{key}_{name}_idx"])
                assert np.array_equal(a.reshape(-1)[idx],
                                      expected[f"{key}_{name}_val"])
            else:
                assert f"{key}_{name}_idx" not in expected
        assert got.fingerprint() == want.fingerprint() == str(
            expected[f"{key}_fingerprint"])
        errs = integrity_errors(got)
        assert errs and errs == json.loads(str(expected[f"{key}_errors"]))


def test_lower_with_faults_keys_the_clone_apart(fuzz0):
    """The corrupted clone is lowered under its own content fingerprint, on
    the device ``lower`` resolves; the pristine cached program stays
    untouched, and the clone's tensors are its corrupted host arrays."""
    art = fuzz0[0]
    cache = lowering.ProgramCache()
    prev = lowering.install(cache)
    try:
        pristine = lower(art, device="cpu")
        snap = {n: getattr(pristine, n).clone()
                for n in lowering.REQUIRED_ARRAYS}
        plan = FaultPlan.parse("seu_weight=64,seu_thr=8,seed=23")
        bad = lower_with_faults(art, plan, device="cpu")
        again = lower_with_faults(pristine, plan, device="cpu")
        assert again is bad and bad is not pristine
        assert bad.fingerprint != pristine.fingerprint
        assert bad.artifact.fingerprint() != art.fingerprint()
        assert cache.stats()["programs"] == 2
        assert lower(art, device="cpu") is pristine
        for name, t in snap.items():
            assert np.array_equal(getattr(pristine, name).numpy(), t.numpy())
            assert np.array_equal(getattr(bad, name).numpy(),
                                  np.asarray(bad.artifact[name]))
        assert not all(np.array_equal(getattr(bad, n).numpy(), snap[n].numpy())
                       for n in lowering.REQUIRED_ARRAYS)
        assert integrity_errors(bad.artifact)
        assert lower_with_faults(art, FaultPlan.none(),
                                 device="cpu") is pristine
    finally:
        lowering.install(prev)


def test_make_runtime_static_plan_any_family_dynamic_board_py_only(fuzz0):
    art, jart = fuzz0[0], fuzz0[1]
    rt = make_runtime(art, "reference", faults="seu_weight=2,seed=1",
                      device="cpu")
    assert integrity_errors(rt.art)
    assert integrity_errors(art) == []
    assert rt.art.fingerprint() == jmake_runtime(
        jart, "reference", faults="seu_weight=2,seed=1").art.fingerprint()
    for spec, faults in (("accelerator-event", "aer_drop=0.1"),
                         ("reference", "membrane=0.5"),
                         ("accelerator-event-fused", "stuck=1"),
                         ("board-batched", "fifo=4")):
        with pytest.raises(ValueError, match="board-py") as got:
            make_runtime(art, spec, faults=faults, device="cpu")
        with pytest.raises(ValueError) as want:
            jmake_runtime(jart, spec, faults=faults)
        assert str(got.value) == str(want.value)
    make_runtime(art, "board-py", faults="aer_drop=0.1", device="cpu")
    # a static plan on every advertised family
    for spec in ("accelerator-event-fused", "accelerator-batch-cuda",
                 "board-batched-cuda", "board-py"):
        rt = make_runtime(art, spec, faults="seu_thr=1,seed=4",
                          device="cpu")
        assert integrity_errors(rt.art), spec


# ------------------------------------------------------------------ AER link
def test_aer_queue_depth_exact_boundary():
    T, n = 4, 6
    times = np.zeros(n, np.int64)
    q_fit = AEREventQueue(times, T, depth=n)
    q_over = AEREventQueue(times, T, depth=n - 1)
    assert q_fit.stalls_at(0) == 0
    assert q_over.stalls_at(0) == 1
    assert q_fit.total_events == q_over.total_events == n


def test_faulty_aer_queue_drop_dup_reorder(fuzz0):
    art = fuzz0[0]
    with np.load(os.path.join(ASSETS, "fuzz_seed0.npz")) as z:
        row = z["times"][0]
    T = int(art.m("encode", "T"))
    depth = int(art.m("events", "e_max"))
    clean = AEREventQueue(row, T, depth)
    drop = FaultyAEREventQueue(row, T, depth,
                               FaultPlan(seed=1, aer_drop_rate=0.5))
    dup = FaultyAEREventQueue(row, T, depth,
                              FaultPlan(seed=1, aer_dup_rate=0.5))
    reorder = FaultyAEREventQueue(row, T, depth,
                                  FaultPlan(seed=1, aer_reorder_rate=0.5))
    assert drop.total_events == clean.total_events - drop.injected_drops
    assert drop.injected_drops > 0
    assert dup.total_events == clean.total_events + dup.injected_dups
    assert dup.injected_dups > 0
    assert reorder.total_events == clean.total_events
    assert reorder.injected_moves > 0

    def ids(q):
        return sorted(int(i) for t in range(T) for i in q.events_at(t))
    assert ids(reorder) == ids(clean)
    drop2 = FaultyAEREventQueue(row, T, depth,
                                FaultPlan(seed=1, aer_drop_rate=0.5))
    assert all(np.array_equal(drop.events_at(t), drop2.events_at(t))
               for t in range(T))
    # the same schedule as JAX's, event for event
    for q, kw in ((drop, {"aer_drop_rate": 0.5}),
                  (dup, {"aer_dup_rate": 0.5}),
                  (reorder, {"aer_reorder_rate": 0.5})):
        jq = JFaultyQueue(row, T, depth, JFaultPlan(seed=1, **kw))
        assert (q.injected_drops, q.injected_dups, q.injected_moves) == (
            jq.injected_drops, jq.injected_dups, jq.injected_moves)
        assert all(np.array_equal(q.events_at(t), jq.events_at(t))
                   for t in range(T))


def test_fifo_depth_override_stalls_only(fuzz0):
    art, images = fuzz0[0], fuzz0[2][:3]
    clean = make_runtime(art, "board-py", device="cpu")
    faulty = make_runtime(art, "board-py", faults="fifo=1", device="cpu")
    out_c, out_f = clean.forward(images), faulty.forward(images)
    assert np.array_equal(out_c.labels, out_f.labels)
    assert np.array_equal(out_c.first_spike, out_f.first_spike)
    assert int(np.sum(faulty.last_trace.stalls)) > int(
        np.sum(clean.last_trace.stalls))
    assert trace_errors(faulty, images) == []


# ------------------------------------------------------------ board datapath
def test_membrane_seu_hits_ecc(fuzz0):
    art, jart, images = fuzz0[0], fuzz0[1], fuzz0[2][:2]
    rt = make_runtime(art, "board-py", faults="membrane=0.9,seed=2",
                      device="cpu")
    rt.forward(images)
    assert int(np.sum(rt.last_ecc)) > 0
    assert ecc_errors(rt)
    clean = make_runtime(art, "board-py", device="cpu")
    clean.forward(images)
    assert ecc_errors(clean) == []
    jrt = jmake_runtime(jart, "board-py", faults="membrane=0.9,seed=2")
    jrt.forward(images)
    assert np.array_equal(rt.last_ecc, jrt.last_ecc)
    assert ecc_errors(rt) == jecc_errors(jrt)


def test_membrane_upset_raises_on_bit_31_like_jax():
    """Bit 31 of a negative membrane word gives a Python int below -2**31:
    JAX's injector wraps only the other way and raises OverflowError there,
    and the port raises the same error, whatever numpy's version; bit 31 of
    a positive word wraps to a negative one in both."""
    class Draws:                      # group 0, lane ``li``, bit 31
        def __init__(self, li):
            self.ints = iter((0, li, 31))

        def rand(self):
            return 0.0

        def randint(self, n):
            return next(self.ints)

    w = np.zeros((2, 128), np.int8)
    thr = np.full(128, 1000, np.int32)
    raised = []
    for core_cls, upset_cls, plan_cls in (
            (GroupedNeuronCore, MembraneUpsetInjector, FaultPlan),
            (JCore, JUpset, JFaultPlan)):
        core = core_cls(w, thr, 4, 8, PYNQ_COST)
        core.v[0, 1] = -1136
        core.v[0, 2] = 77
        upset = upset_cls(plan_cls(seu_membrane_rate=1.0))
        upset._rng = Draws(1)
        with pytest.raises(OverflowError) as e:
            upset.after_tick(core, 0)
        raised.append(str(e.value))
        assert int(core.v[0, 1]) == -1136 and upset.ecc_hits == 0
        upset._rng = Draws(2)
        upset.after_tick(core, 0)
        assert core.v.dtype == np.int32 and upset.ecc_hits == 1
        assert int(core.v[0, 2]) == 77 - 2 ** 31
    assert raised[0] == raised[1] == (
        f"Python integer {-1136 ^ (1 << 31)} out of bounds for int32")


@pytest.mark.parametrize("case", CASES)
def test_board_py_dynamic_plans_equal_jax(cases, expected, case):
    """board-py under every dynamic plan, full-T and latency mode: outputs,
    trace, tick histogram, ``last_ecc`` and stuck groups equal JAX's (the
    committed asset, which the test below holds to a fresh JAX export).
    Where JAX's membrane upset raised, the port raises JAX's error, which
    names the same out-of-range word."""
    art, _, images, _ = cases[case]
    for i, spec in enumerate(SCRIPT.DYNAMIC_PLANS):
        for mode, latency in (("full", False), ("latency", True)):
            key = f"board_{case}_{i}_{mode}"
            rt = make_runtime(art, "board-py", latency_mode=latency,
                              faults=spec, device="cpu")
            if f"{key}_jax_raises" in expected:
                with pytest.raises(OverflowError) as e:
                    rt.forward(images)
                assert str(e.value) == str(expected[f"{key}_jax_raises"])
                continue
            out = rt.forward(images)
            assert np.array_equal(out.labels.numpy(),
                                  expected[f"{key}_labels"]), (spec, mode)
            assert np.array_equal(out.steps.numpy(),
                                  expected[f"{key}_steps"]), (spec, mode)
            for name, got in (("first_spike", out.first_spike.numpy()),
                              ("v_final", out.v_final.numpy()),
                              ("tick_counts", rt.last_tick_counts)):
                assert SCRIPT.digest(got) == str(
                    expected[f"{key}_{name}_sha256"]), (spec, mode, name)
            assert np.array_equal(rt.last_ecc, expected[f"{key}_ecc"])
            assert rt.last_ecc.dtype == expected[f"{key}_ecc"].dtype
            assert rt.stuck_groups == expected[f"{key}_stuck"].tolist()
            for k in SCRIPT.BOARD_TRACE:
                a, b = getattr(rt.last_trace, k), expected[f"{key}_{k}"]
                assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_apply_stuck_modes_and_readout_restriction():
    art = Artifact.load(MNIST_ART)
    n_out = int(art.m("model", "n_out"))
    core = GroupedNeuronCore.from_artifact(art, PYNQ_COST)
    readout_span = -(-n_out // core.lane)
    sat = apply_stuck(core, FaultPlan(seed=3, stuck_groups=2), n_out=n_out)
    assert len(sat) == 2 and all(g < readout_span for g in sat)
    assert all(np.all(core.thr[g, :] == np.iinfo(np.int32).min) for g in sat)
    core2 = GroupedNeuronCore.from_artifact(art, PYNQ_COST)
    sil = apply_stuck(core2, FaultPlan(seed=3, stuck_groups=1,
                                       stuck_mode="silent"), n_out=n_out)
    assert all(np.all(core2.thr[g, :] == INT32_NEVER_FIRE) for g in sil)
    with pytest.raises(ValueError, match="stuck_mode"):
        apply_stuck(core2, FaultPlan(stuck_groups=1, stuck_mode="wedged"))
    assert apply_stuck(core2, FaultPlan.none()) == []
    # the program's tensors stay untouched: the core owns host copies
    prog = lower(art, device="cpu")
    assert np.array_equal(prog.thr_padded.numpy(), art["thr_padded"])


def test_trace_detector_catches_aer_glitches(fuzz0):
    art, jart, images = fuzz0[0], fuzz0[1], fuzz0[2][:3]
    clean = make_runtime(art, "board-py", device="cpu")
    clean.forward(images)
    assert trace_errors(clean, images) == []
    glitched = make_runtime(art, "board-py", faults="aer_drop=0.3,seed=4",
                            device="cpu")
    glitched.forward(images)
    errs = trace_errors(glitched, images)
    assert errs and any("histogram" in e for e in errs)
    jglitched = jmake_runtime(jart, "board-py", faults="aer_drop=0.3,seed=4")
    jglitched.forward(images)
    assert errs == jtrace_errors(jglitched, images)
    # the batched board exposes the histogram too: clean, no error
    bt = make_runtime(art, "board-batched-cuda", device="cpu")
    bt.forward(images)
    assert trace_errors(bt, images) == []
    assert trace_errors(make_runtime(art, "reference", device="cpu"),
                        images) == []


# -------------------------------------------------------------------- canary
def test_canary_probes_detect_stuck_group():
    art = Artifact.load(MNIST_ART)
    xte = mnist.generate(10_000, 1235)[0][:64]
    canary = Canary.from_artifact(art, pool=xte, device="cpu")
    assert len(canary.covered_groups) >= 2
    assert canary.mismatches(canary.want) == []
    flipped = np.array(canary.want)
    flipped[0] = (flipped[0] + 1) % canary.n_groups
    assert canary.mismatches(flipped)
    rt = make_runtime(art, "board-py", faults="stuck=1,seed=5", device="cpu")
    got = rt.forward(canary.images).labels
    assert canary.mismatches(got)
    jcanary = JCanary.from_artifact(JArtifact.load(MNIST_ART), pool=xte)
    assert canary.mismatches(got) == jcanary.mismatches(np.asarray(got))


@pytest.mark.parametrize("case", CASES)
def test_canary_equals_jax(cases, expected, case):
    """The probe images are JAX's to the bit (float64 numpy arithmetic,
    then float32), and so are the kept set, the wanted labels and the
    covered groups."""
    art, _, _, pool = cases[case]
    canary = Canary.from_artifact(art, pool=pool, device="cpu")
    assert canary.images.dtype == np.float32
    assert canary.images.tobytes() == expected[
        f"canary_{case}_images"].tobytes()
    assert np.array_equal(canary.want, expected[f"canary_{case}_want"])
    assert canary.want.dtype == expected[f"canary_{case}_want"].dtype
    assert list(canary.covered_groups) == expected[
        f"canary_{case}_covered"].tolist()
    assert canary.n_groups == int(art.m("readout", "n_groups"))


# ------------------------------------------------------- clean-plan guarantee
def test_clean_plan_board_py_bitexact_with_golden(fuzz0):
    art, images = fuzz0[0], fuzz0[2][:5]
    plain = make_runtime(art, "board-py", device="cpu")
    hooked = make_runtime(art, "board-py", faults=FaultPlan.none(),
                          device="cpu")
    out_p, out_h = plain.forward(images), hooked.forward(images)
    for f in OUTPUTS:
        assert np.array_equal(getattr(out_p, f), getattr(out_h, f)), f
    for f in dataclasses.fields(plain.last_trace):
        assert np.array_equal(np.asarray(getattr(plain.last_trace, f.name)),
                              np.asarray(getattr(hooked.last_trace, f.name)))
    assert np.array_equal(hooked.last_ecc, np.zeros(5, np.int64))
    with np.load(os.path.join(GOLDEN, "conformance_seed0.npz")) as z:
        assert np.array_equal(out_h.labels, z["labels"][:5])
        assert np.array_equal(out_h.first_spike, z["first_spike"][:5])
        assert np.array_equal(hooked.last_trace.cycles,
                              z["board_cycles"][:5])
        assert np.array_equal(hooked.last_trace.energy_nj,
                              z["board_energy_nj"][:5])


def test_clean_plan_static_sites_inert(fuzz0):
    art = fuzz0[0]
    meta_before = copy.deepcopy(art.meta)
    rt = make_runtime(art, "reference", faults=FaultPlan.none(),
                      device="cpu")
    assert rt.program.fingerprint == lower(art, device="cpu",
                                           cache=False).fingerprint
    assert rt.art.fingerprint() == art.fingerprint()
    assert art.meta == meta_before


def test_committed_faults_assets_equal_a_fresh_jax_export(expected):
    fresh = SCRIPT.faults_expected(ASSETS)
    assert set(fresh) == set(expected)
    for k, a in fresh.items():
        assert a.dtype == expected[k].dtype and np.array_equal(
            a, expected[k]), k
