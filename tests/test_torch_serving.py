"""The port's runtimes and serving tier against the JAX package on the CPU:
every advertised spec (the ``-cuda`` ones included, on their kernels' plain
versions) against the golden conformance seeds, the served MNIST artifact
against the JAX SNNServeEngine (full-T and latency mode), the overflow→dense
reroute, and every path the port refuses so far (the board family is held
in ``test_torch_board.py``)."""

import copy
import io
import os

import numpy as np
import pytest

from repro.core.artifact import Artifact as JArtifact
from repro.serving.snn_engine import SNNServeEngine as JEngine
from repro_torch.core import lowering
from repro_torch.core.accelerator import SNNAccelerator
from repro_torch.core.artifact import Artifact
from repro_torch.core.reference import SNNReference
from repro_torch.core.runtimes import ADVERTISED_SPECS, make_runtime
from repro_torch.data import mnist
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
    art = Artifact.load(MNIST_ART)
    refused = [
        lambda: SNNServeEngine(art, workers=1, device="cpu"),
        lambda: SNNServeEngine(art, faults="crash=0", device="cpu"),
        lambda: SNNServeEngine(art, canary_pool=np.zeros((1, 784), np.float32),
                               device="cpu"),
        lambda: SNNServeEngine(art, resilience={"verify": True},
                               device="cpu"),
        lambda: SNNServeEngine(art, max_wait_us=500.0, device="cpu"),
        lambda: make_runtime(art, "board-py", faults="seu_membrane=1",
                             device="cpu"),
        lambda: make_runtime(art, "reference", faults="seu_weight=1",
                             device="cpu"),
        lambda: lowering.lower_with_faults(art, None),
    ]
    for make in refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make()
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
    art = Artifact.load(MNIST_ART)
    art.arrays["w_padded"] = art.arrays["w_padded"].copy()
    art.arrays["w_padded"][3, 3] ^= 1
    with pytest.raises(RuntimeError, match="startup checks"):
        SNNServeEngine(art, device="cpu")
