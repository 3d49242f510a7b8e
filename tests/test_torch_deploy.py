"""``deploy.export`` in the port against the JAX package's on the CPU: the
same float weights give the same artifact — fingerprint, every array byte
for byte, and meta (``calib_accuracy`` and the chosen ``leak_shift``
included); tolerance 0 everywhere. Weights: a seeded numpy draw and the
committed MNIST artifact's trained ``w_float``, calibrated on
``generate(512, 7)``; also a tau that maps to shift 31 (one leak candidate)
and 500 images (a count whose accuracy is not a float32 power-of-two
fraction). Two planted faults: a float64 accuracy must change the
fingerprint, and the quantiles must be numpy's (``torch.quantile`` is never
called). And, without JAX, the committed artifact re-exported from its
``w_float`` on ``generate(60000, 1234)[:8192]`` (about 16 s on a CPU, 12 of
them generating the images) has the fingerprints JAX's export recorded."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as jdeploy
from repro.core import snn as jsnn
from repro.core.artifact import Artifact as JArtifact
from repro_torch.core import deploy, snn
from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import lower
from repro_torch.data import mnist

ASSETS = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                      "assets")


@pytest.fixture(scope="module")
def calib():
    return mnist.generate(512, 7)


def _seeded_w():
    return (np.random.RandomState(20).randn(784, 150) * 0.05).astype(
        np.float32)


def _trained_w():
    return Artifact.load(os.path.join(ASSETS, "mnist_ttfs.npz"))["w_float"]


def _export_both(w, x, y, tau=16.0, **kw):
    jm = jsnn.SNN(jsnn.Sequential(jsnn.Linear(*w.shape), jsnn.LIF(tau=tau)))
    jm.body.layers[0].params = {"w": w}
    jart = jdeploy.export(jm, calib_images=x, calib_labels=y, **kw)
    m = snn.SNN(snn.Sequential(snn.Linear(*w.shape, device="cpu"),
                               snn.LIF(tau=tau)))
    snn.load_params(m, [{"w": w}, {}])
    art = deploy.export(m, calib_images=x, calib_labels=y, device="cpu", **kw)
    return jart, art


def _assert_same_artifact(art, jart):
    assert sorted(art.arrays) == sorted(jart.arrays)
    for k, want in jart.arrays.items():
        got = art.arrays[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    assert art.meta == jart.meta
    assert art.fingerprint() == jart.fingerprint()


@pytest.mark.parametrize("weights", ["seeded", "trained"])
def test_export_equals_jax(weights, calib):
    w = _seeded_w() if weights == "seeded" else _trained_w()
    jart, art = _export_both(w, *calib)
    _assert_same_artifact(art, jart)
    assert art.meta["lif"]["leak_shift"] in (4, 31)
    acc = art.meta["lif"]["calibration"]["calib_accuracy"]
    assert acc == jart.meta["lif"]["calibration"]["calib_accuracy"]
    if weights == "trained":
        assert acc > 0.8                  # a trained model calibrates well
    assert lower(art, device="cpu", cache=False).n_pad == 256


def test_export_with_no_leak_tries_shift_31_alone(calib):
    """tau 0 maps to shift 31: the candidate set is {31}, as in JAX."""
    jart, art = _export_both(_trained_w(), *calib, tau=0.0)
    _assert_same_artifact(art, jart)
    assert art.meta["lif"]["leak_shift"] == 31


def test_export_with_a_path_saves_the_same_file(calib, tmp_path):
    x, y = calib[0][:128], calib[1][:128]
    w = _trained_w()
    jm = jsnn.SNN(jsnn.Sequential(jsnn.Linear(784, 150), jsnn.LIF()))
    jm.body.layers[0].params = {"w": w}
    jdeploy.export(jm, str(tmp_path / "j.npz"), calib_images=x,
                   calib_labels=y, e_max_headroom=1.5)
    m = snn.load_params(snn.SNN(snn.Sequential(
        snn.Linear(784, 150, device="cpu"), snn.LIF())), [{"w": w}, {}])
    deploy.export(m, str(tmp_path / "t.npz"), calib_images=x,
                  calib_labels=y, e_max_headroom=1.5, device="cpu")
    got = Artifact.load(str(tmp_path / "t.npz"))
    want = JArtifact.load(str(tmp_path / "j.npz"))
    assert got.meta == want.meta and got.fingerprint() == want.fingerprint()


def test_float64_accuracy_changes_the_fingerprint(calib, monkeypatch):
    """Planted fault: dividing the calibration count in float64 stores
    another ``calib_accuracy`` on 500 images, and with it another
    fingerprint; the port's float32 product gives JAX's."""
    x, y = calib[0][:500], calib[1][:500]
    jart, art = _export_both(_trained_w(), x, y)
    _assert_same_artifact(art, jart)
    monkeypatch.setattr(deploy, "_mean_accuracy", lambda c, n: c / n)
    _, bad = _export_both(_trained_w(), x, y)
    assert bad.meta["lif"]["calibration"]["calib_accuracy"] != \
        jart.meta["lif"]["calibration"]["calib_accuracy"]
    assert bad.fingerprint() != jart.fingerprint()


def test_quantiles_are_numpys_on_the_host(calib, monkeypatch):
    """``np.quantile`` on the host's int32 peaks, once per (leak, q): never
    ``torch.quantile``."""
    calls = []
    real = np.quantile

    def spy(a, q, **kw):
        calls.append((a.dtype, q))
        return real(a, q, **kw)

    def refuse(*a, **kw):
        raise AssertionError("torch.quantile called")

    monkeypatch.setattr(np, "quantile", spy)
    monkeypatch.setattr(torch, "quantile", refuse)
    m = snn.load_params(snn.SNN(snn.Sequential(
        snn.Linear(784, 150, device="cpu"), snn.LIF())),
        [{"w": _trained_w()}, {}])
    deploy.export(m, calib_images=calib[0][:64], calib_labels=calib[1][:64],
                  device="cpu")
    assert calls == [(np.dtype(np.int32), q) for _ in (4, 31)
                     for q in (0.85, 0.9)]


def test_mean_accuracy_equals_jax_mean():
    """``float(jnp.mean(pred == labels))`` for every count of 500 and 777
    images and a stride of 8,192: XLA multiplies by the float32 reciprocal,
    which a float32 division misses on some counts."""
    div_differs = 0
    for n, stride in ((500, 1), (777, 1), (8192, 61)):
        labels = jnp.zeros(n, jnp.int32)
        for c in range(0, n + 1, stride):
            pred = jnp.where(jnp.arange(n) < c, 0, 1)
            want = float(jnp.mean(pred == labels))
            assert deploy._mean_accuracy(c, n) == want, (c, n)
            div_differs += want != float(np.float32(c) / np.float32(n))
    assert div_differs > 0


def test_reexport_of_the_committed_artifact_without_jax(tmp_path):
    """The fixture's own export, by the port alone: the artifact and program
    fingerprints ``mnist_ttfs_expected.npz`` recorded from JAX's."""
    exp = np.load(os.path.join(ASSETS, "mnist_ttfs_expected.npz"))
    x, y = mnist.generate(60_000, 1234)
    m = snn.load_params(snn.SNN(snn.Sequential(
        snn.Linear(784, 150, device="cpu"), snn.LIF())),
        [{"w": _trained_w()}, {}])
    path = str(tmp_path / "mnist_ttfs.npz")
    deploy.export(m, path, calib_images=x[:8192], calib_labels=y[:8192],
                  device="cpu")
    art = Artifact.load(path)
    assert art.fingerprint() == str(exp["artifact_fingerprint"])
    assert lower(art, device="cpu", cache=False).fingerprint == \
        str(exp["program_fingerprint"])
