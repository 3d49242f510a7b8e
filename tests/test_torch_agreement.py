"""The port's three-way agreement harness and the dense Table-3 baselines
against the JAX package on the CPU: the report of ``full_agreement`` on
1,024 MNIST test images field for field, a divergent runtime reported and
not swallowed, the repeatability protocol, and the dense FP32/INT8 logits
and labels, with the INT8 product's exact-slice width pinned on an input
too wide for one float32 slice."""

import contextlib
import hashlib
import io
import os

import numpy as np
import pytest
import torch

from repro.core.agreement import full_agreement as jfull_agreement
from repro.core.agreement import repeatability as jrepeatability
from repro.core.artifact import Artifact as JArtifact
from repro.core.reference import SNNReference as JReference
from repro_torch.core import runtimes
from repro_torch.core.agreement import (AgreementReport, full_agreement,
                                        repeatability)
from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import MAX_EXACT_N_IN
from repro_torch.core.reference import (MAX_EXACT_N_IN_INT8, SNNReference,
                                        exact_int_product)
from repro_torch.core.types import SNNOutput
from repro_torch.data import mnist

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
MNIST_ART = os.path.join(ASSETS, "mnist_ttfs.npz")
REPORT_FIELDS = ("n_images", "runtimes", "label_mismatches",
                 "spike_time_mismatches", "accuracy", "exact_match")


@pytest.fixture(scope="module")
def test_set():
    return mnist.load("test")


class DivergentRuntime:
    """The reference with one label and one first-spike time flipped."""

    def __init__(self, prog):
        self._ref = SNNReference(prog, device=prog.device)

    def forward(self, images):
        out = self._ref.forward(images)
        labels = out.labels.clone()
        labels[0] = (labels[0] + 1) % max(2, int(labels.max()) + 1)
        first = out.first_spike.clone()
        first[0, 0] += 1
        return SNNOutput(labels, first, out.v_final, out.steps)


@contextlib.contextmanager
def divergent_family(name: str = "divergent"):
    runtimes._REGISTRY[name] = lambda prog, opts, **kw: DivergentRuntime(prog)
    try:
        yield
    finally:
        del runtimes._REGISTRY[name]


def test_full_agreement_equals_jax_report(test_set):
    """The default three-way harness (reference / accelerator-batch /
    accelerator-event / board) on 1,024 images: exact, and every report
    field equal to JAX's."""
    x, y = test_set[0][:1024], test_set[1][:1024]
    got = full_agreement(Artifact.load(MNIST_ART), x, y, chunk=512,
                         device="cpu")
    want = jfull_agreement(JArtifact.load(MNIST_ART), x, y, chunk=512)
    assert got.exact_match, got.summary()
    for field in REPORT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.runtimes == ["reference", "accelerator-batch",
                            "accelerator-event", "board"]


def test_full_agreement_on_every_cuda_route(test_set):
    """The specs the card runs, here on their kernels' plain versions, and
    the per-image board scheduler."""
    x, y = test_set[0][:256], test_set[1][:256]
    specs = ("accelerator-batch-cuda", "accelerator-event-fused",
             "accelerator-event-cuda", "board-batched-cuda", "board-py")
    rep = full_agreement(Artifact.load(MNIST_ART), x, y, runtimes=specs,
                         chunk=128, device="cpu")
    assert rep.exact_match, rep.summary()
    assert set(rep.label_mismatches) == set(specs)
    assert len(set(rep.accuracy.values())) == 1


def test_divergent_runtime_reported_not_swallowed(test_set):
    x, y = test_set[0][:32], test_set[1][:32]
    with divergent_family():
        rep = full_agreement(Artifact.load(MNIST_ART), x, y,
                             runtimes=("divergent", "board"), chunk=32,
                             device="cpu")
    assert not rep.exact_match
    assert rep.label_mismatches == {"divergent": 1, "board": 0}
    assert rep.spike_time_mismatches == {"divergent": 1, "board": 0}
    s = rep.summary()
    assert "label_mismatch=1" in s and "EXACT MATCH: False" in s
    assert "divergent" not in runtimes.available()


def test_agreement_report_summary_renders_every_field():
    rep = AgreementReport(
        n_images=4, runtimes=["reference", "fake-rt"],
        label_mismatches={"fake-rt": 2}, spike_time_mismatches={"fake-rt": 1},
        accuracy={"reference": 1.0, "fake-rt": 0.5},
        exact_match=False, wall_s=0.25)
    s = rep.summary()
    assert "agreement over 4 images" in s
    assert "label_mismatch=2" in s and "spike_time_mismatch=1" in s
    assert "acc=50.0000%" in s and "EXACT MATCH: False" in s


def test_repeatability_equals_jax(test_set):
    x, y = test_set[0][:256], test_set[1][:256]
    got = repeatability(Artifact.load(MNIST_ART), x, y, runs=5, chunk=128,
                        device="cpu")
    want = jrepeatability(JArtifact.load(MNIST_ART), x, y, runs=5, chunk=128)
    assert got == want
    assert got["mismatches"] == 0 and got["image_run_pairs"] == 5 * 256
    assert got["accuracy_stable"]


def test_repeatability_on_fuzz_artifact():
    with np.load(os.path.join(ASSETS, "fuzz_seed3.npz")) as z:
        art = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
        images = z["images"]
    r = repeatability(art, images, np.zeros(len(images), np.int64), runs=3,
                      chunk=8, device="cpu")
    assert r["mismatches"] == 0 and r["image_run_pairs"] == 3 * len(images)
    assert len(r["accuracy_per_run"]) == 3 and r["accuracy_stable"]


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_dense_baselines_match_jax(test_set, mode):
    """Logits within 1e-5 of JAX's, relative to each row's largest logit
    (an element near zero has no relative error to speak of), and equal
    labels on 256 images; on all 10,000, the labels' digest equals JAX's
    (``mnist_board_expected.npz``)."""
    x = test_set[0]
    ref = SNNReference(Artifact.load(MNIST_ART), device="cpu")
    jref = JReference(JArtifact.load(MNIST_ART))
    fn = {"fp32": (ref.dense_logits_fp32, jref.dense_logits_fp32),
          "int8": (ref.dense_logits_int8, jref.dense_logits_int8)}[mode]
    got, want = fn[0](x[:256]).numpy(), np.asarray(fn[1](x[:256]))
    assert got.dtype == np.float32 and got.shape == want.shape == (256, 10)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    assert np.array_equal(ref.dense_labels(x[:256], mode).numpy(),
                          np.asarray(jref.dense_labels(x[:256], mode)))
    labels = np.concatenate([ref.dense_labels(x[i:i + 2500], mode).numpy()
                             for i in range(0, len(x), 2500)])
    assert labels.dtype == np.int32
    with np.load(os.path.join(ASSETS, "mnist_board_expected.npz")) as exp:
        assert hashlib.sha256(labels.tobytes()).hexdigest() == \
            str(exp[f"dense_{mode}_labels_sha256"])
        assert np.mean(labels == test_set[1]) == float(
            exp[f"dense_{mode}_accuracy"])
    with pytest.raises(ValueError, match="dense mode"):
        ref.dense_labels(x[:4], "bf16")


def test_dense_int8_product_is_exact_past_one_float32_slice():
    """n_in 2,000 inputs at 127 against weights of -128 and -127: each sum
    is about -3.2e7, past 2**24, and odd where it has an odd number of -127
    terms, so one float32 product cannot hold it. Slices of
    ``MAX_EXACT_N_IN_INT8`` (1,032) inputs are exact; slices sized by
    ``MAX_EXACT_N_IN`` (for a {0,1} raster) are not. Held against int64
    numpy on a synthetic program."""
    assert 127 * 128 * MAX_EXACT_N_IN_INT8 < 2 ** 24 <= \
        127 * 128 * (MAX_EXACT_N_IN_INT8 + 1)
    n_in, n_groups, per_group = 2000, 2, 2
    n_out = n_groups * per_group
    rng = np.random.RandomState(0)
    w = np.full((n_in, n_out), -128, np.int8)
    w[rng.rand(n_in, n_out) < 0.5] = -127
    images = np.ones((3, n_in), np.float32)
    images[1, ::7] = 0.5                  # round(63.5) = 64, half to even
    x_q = np.clip(np.round(images * 127.0), 0, 127).astype(np.int64)
    z = x_q @ w.astype(np.int64)
    assert np.abs(z).max() > 2 ** 24 and np.any(z % 2)
    got = exact_int_product(torch.from_numpy(x_q).float(),
                            torch.from_numpy(w).float(), MAX_EXACT_N_IN_INT8)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), z)
    wide = exact_int_product(torch.from_numpy(x_q).float(),
                             torch.from_numpy(w).float(), MAX_EXACT_N_IN)
    assert not np.array_equal(wide.numpy(), z)
    # the program route: the reference's dense int8 logits are the grouped
    # float32 mean of the exact sums
    meta = {"encode": {"T": 8, "x_min": 1.0 / 255.0},
            "events": {"e_max": 16}, "lif": {"leak_shift": 4},
            "model": {"n_in": n_in, "n_out": n_out},
            "readout": {"n_groups": n_groups, "per_group": per_group,
                        "fallback": "membrane"},
            "quant": {"scale": 1.0}, "codesign": {"lane": 128}}
    w_pad = np.zeros((n_in, 128), np.int8)
    w_pad[:, :n_out] = w
    arrays = {"w_float": w.astype(np.float32), "w_int8": w,
              "thresholds": np.full(n_out, 100, np.int32),
              "w_padded": w_pad,
              "thr_padded": np.full(128, 2 ** 30, np.int32)}
    ref = SNNReference(Artifact(meta, arrays), device="cpu")
    want = torch.from_numpy(z.astype(np.int32)).float().reshape(
        -1, n_groups, per_group).mean(dim=-1)
    assert torch.equal(ref.dense_logits_int8(images), want)
