"""The port's runtimes and serving tier against the JAX package on the CPU:
every advertised spec (the ``-cuda`` ones included, on their kernels' plain
versions) against the golden conformance seeds, the served MNIST artifact
against the JAX SNNServeEngine (full-T and latency mode), the overflow→dense
reroute, the serving paths once refused and now JAX's (worker lanes, fault
plans, canaries, a tampered artifact's quarantine), and what the port still
refuses (the board family is held in ``test_torch_board.py``)."""

import copy
import io
import os

import numpy as np
import pytest

from repro.core import lowering as jlowering
from repro.core.artifact import Artifact as JArtifact
from repro.core.runtimes import make_runtime as jmake_runtime
from repro.faults import FaultPlan as JFaultPlan
from repro.serving.snn_engine import SNNServeEngine as JEngine
from repro_torch.core import lowering
from repro_torch.core.accelerator import SNNAccelerator
from repro_torch.core.artifact import Artifact
from repro_torch.core.reference import SNNReference
from repro_torch.core.runtimes import ADVERTISED_SPECS, make_runtime
from repro_torch.data import mnist
from repro_torch.faults import FaultPlan
from repro_torch.serving.snn_engine import SNNServeEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MNIST_ART = os.path.join(ASSETS, "mnist_ttfs.npz")
KEYS = ("labels", "first_spike", "v_final", "steps")


def fuzz_case(seed: int):
    with np.load(os.path.join(ASSETS, f"fuzz_seed{seed}.npz")) as z:
        art = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
        images = z["images"]
    with np.load(os.path.join(GOLDEN, f"conformance_seed{seed}.npz")) as g:
        golden = {k: g[k] for k in g.files}
    return art, images, golden


@pytest.fixture(scope="module")
def served_images():
    x, _ = mnist.generate(256, 1235)       # the first 256 test images
    return x


@pytest.mark.parametrize("seed", range(8))
def test_reference_and_specs_match_golden(seed):
    art, images, golden = fuzz_case(seed)
    out = SNNReference(art, device="cpu").forward(images)
    for key in KEYS:
        assert np.array_equal(getattr(out, key).numpy(), golden[key]), key
    for spec in ADVERTISED_SPECS:
        out = make_runtime(art, spec, device="cpu").forward(images)
        for key in KEYS:
            assert np.array_equal(getattr(out, key).numpy(), golden[key]), \
                (spec, key)
    latency = {}
    for kernel in ("fused", "torch", "cuda"):
        acc = SNNAccelerator(art, mode="event", kernel=kernel, device="cpu")
        out = acc.forward(images, latency_mode=True)
        assert np.array_equal(out.labels.numpy(), golden["labels"]), kernel
        latency[kernel] = out
    # the staged early exit freezes each row where the fused kernel stops
    for kernel in ("torch", "cuda"):
        for key in KEYS:
            assert np.array_equal(getattr(latency[kernel], key).numpy(),
                                  getattr(latency["fused"], key).numpy()), \
                (kernel, key)


@pytest.mark.parametrize("latency_mode", [False, True])
def test_engine_matches_jax_engine_on_mnist(served_images, latency_mode):
    want_eng = JEngine(JArtifact.load(MNIST_ART), max_batch=64,
                       latency_mode=latency_mode)
    got_eng = SNNServeEngine(Artifact.load(MNIST_ART), max_batch=64,
                             latency_mode=latency_mode, device="cpu")
    results = []
    for eng in (want_eng, got_eng):
        for img in served_images:
            eng.submit(img)
        done = eng.flush()
        reqs = [done[r] for r in sorted(done)]
        results.append((np.asarray([r.label for r in reqs]),
                        np.asarray([r.steps for r in reqs])))
        eng.close()
    assert len(results[1][0]) == len(served_images)
    assert np.array_equal(results[0][0], results[1][0])
    assert np.array_equal(results[0][1], results[1][1])
    st = got_eng.stats()
    assert st["images_out"] == 256 and st["batches"] == 4
    assert st["errors"] == 0 and st["integrity_checks"] == 1
    assert st["lane_health"] == ["healthy"]
    assert st["system_s"] >= st["accelerator_s"] > 0
    transport = {k for k in st if k.startswith("transport_")}
    assert transport == {k for k in want_eng.stats()
                         if k.startswith("transport_")}
    assert len(transport) == 7


def test_overflow_reroute_matches_jax(served_images):
    images = served_images[:64]
    results = []
    for load, engine, kw in ((JArtifact.load, JEngine, {}),
                             (Artifact.load, SNNServeEngine,
                              {"device": "cpu"})):
        art = load(MNIST_ART)
        meta = copy.deepcopy(art.meta)
        meta["events"]["e_max"] = 8
        eng = engine(type(art)(meta, dict(art.arrays)), max_batch=64, **kw)
        for img in images:
            eng.submit(img)
        done = eng.flush()
        reqs = [done[r] for r in sorted(done)]
        results.append(([r.label for r in reqs],
                        [r.fallback_dense for r in reqs],
                        eng.stats()["overflow_fallbacks"]))
    assert results[1][2] > 0
    assert results[0] == results[1]
    want = SNNReference(Artifact.load(MNIST_ART), device="cpu")
    assert results[1][0] == want.forward(images).labels.tolist()


def test_refused_paths_raise_not_implemented():
    """Nothing of the serving tier raises NotImplementedError any more: the
    paths once refused here do what the JAX package does with the same
    arguments, and the port still refuses what JAX refuses."""
    art, jart = Artifact.load(MNIST_ART), JArtifact.load(MNIST_ART)
    x = np.asarray(mnist.generate(8, 1235)[0])
    # worker lanes, a batching deadline, per-batch verification and a canary
    # pool: each engine serves the reference's labels with JAX's settings
    want = SNNReference(art, device="cpu").forward(x).labels.tolist()
    for kw in ({"workers": 1}, {"max_wait_us": 500.0},
               {"resilience": {"verify": True}},
               {"canary_pool": np.zeros((1, 784), np.float32)}):
        eng = SNNServeEngine(art, max_batch=4, device="cpu", **kw)
        jeng = JEngine(jart, max_batch=4, kernel="jnp", **kw)
        try:
            assert eng.classify(x).tolist() == want, kw
            assert jeng.classify(x).tolist() == want, kw
            st, jst = eng.stats(), jeng.stats()
        finally:
            eng.close()
            jeng.close()
        for key in ("workers", "max_wait_us", "canary_checks",
                    "integrity_checks", "trace_checks", "images_out",
                    "lane_health"):
            assert st[key] == jst[key], (kw, key)
    # a lane crash in inline mode: the batch error-completes and the first
    # flush re-raises, as in JAX; nothing strands
    eng = SNNServeEngine(art, max_batch=4, faults="crash=0", device="cpu")
    jeng = JEngine(jart, max_batch=4, kernel="jnp", faults="crash=0")
    errors = []
    for e in (eng, jeng):
        rids = [e.submit(img) for img in x[:4]]
        with pytest.raises(RuntimeError, match="injected lane crash") as ei:
            e.flush()
        done = e.flush()
        errors.append((str(ei.value), sorted(done) == rids,
                       [done[r].error for r in rids],
                       e.stats()["errors"]))
        e.close()
    assert errors[0] == errors[1]
    # fault plans in the registry and the static lowering pass
    with pytest.raises(ValueError, match="unknown fault-plan key") as got:
        make_runtime(art, "board-py", faults="seu_membrane=1", device="cpu")
    with pytest.raises(ValueError) as jgot:
        jmake_runtime(jart, "board-py", faults="seu_membrane=1")
    assert str(got.value) == str(jgot.value)
    rt = make_runtime(art, "reference", faults="seu_weight=1", device="cpu")
    jrt = jmake_runtime(jart, "reference", faults="seu_weight=1")
    assert rt.art.fingerprint() == jrt.art.fingerprint() != art.fingerprint()
    for lower_with_faults in (
            lambda: lowering.lower_with_faults(art, None, device="cpu"),
            lambda: jlowering.lower_with_faults(jart, None)):
        with pytest.raises(AttributeError, match="has_static"):
            lower_with_faults()
    plan = "seu_weight=3,seu_thr=1,seed=9"
    assert lowering.lower_with_faults(
        art, FaultPlan.parse(plan), device="cpu").fingerprint == \
        jlowering.lower_with_faults(jart, JFaultPlan.parse(plan)).fingerprint
    with pytest.raises(ValueError):
        SNNServeEngine(art, backend="bogus", device="cpu")
    with pytest.raises(ValueError):
        make_runtime(art, "accelerator-batch-fused", device="cpu")
    # the JAX package's kernel name is no alias of the port's CUDA kernels
    for make in (
            lambda: make_runtime(art, "accelerator-batch-pallas",
                                 device="cpu"),
            lambda: make_runtime(art, "accelerator-event-pallas",
                                 device="cpu"),
            lambda: SNNAccelerator(art, mode="event", kernel="pallas",
                                   device="cpu"),
            lambda: SNNServeEngine(art, kernel="pallas", device="cpu")):
        with pytest.raises(ValueError, match="cuda"):
            make()


def test_engine_rejects_malformed_images_and_closes_cleanly():
    eng = SNNServeEngine(Artifact.load(MNIST_ART), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.submit(np.zeros(10, np.float32))
    rid = eng.submit(np.zeros(784, np.float32))
    eng.close()
    done = eng.flush()
    assert done[rid].error == "scheduler closed"
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros(784, np.float32))


def test_tampered_artifact_fails_lane_commissioning():
    """A flipped bit in the artifact fails the lane's startup checksum; the
    rebuild from the same (tampered) artifact fails it again, so the lane is
    quarantined and circuit-broken onto the dense path, as in JAX: every
    request is served and flagged ``fallback_dense``."""
    served = []
    for load, engine, kw in ((JArtifact.load, JEngine, {"kernel": "jnp"}),
                             (Artifact.load, SNNServeEngine,
                              {"device": "cpu"})):
        art = load(MNIST_ART)
        art.arrays["w_padded"] = art.arrays["w_padded"].copy()
        art.arrays["w_padded"][3, 3] ^= 1
        eng = engine(art, max_batch=8, **kw)
        x = np.asarray(mnist.generate(8, 1235)[0])
        rids = [eng.submit(img) for img in x]
        done = eng.flush()
        st = eng.stats()
        eng.close()
        served.append(([done[r].label for r in rids],
                       [done[r].fallback_dense for r in rids],
                       {k: st[k] for k in ("integrity_checks",
                                           "integrity_failures",
                                           "lane_faults", "quarantines",
                                           "breaker_degraded", "errors",
                                           "lane_health")}))
    assert served[0] == served[1]
    assert all(served[1][1])
    assert served[1][2]["integrity_failures"] == 2
    assert served[1][2]["lane_health"] == ["degraded"]
