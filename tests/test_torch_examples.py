"""The port's five examples (``examples/torch_*.py``), each run on the CPU
at its smallest setting through its ``main(argv)``, with its own checks
held: quickstart's three-way agreement, the main experiment's agreement,
repeatability and sparsity sweep, the LM examples on reduced configs, and
an elastic run resumed from its checkpoint equal to one never stopped.
The two SNN examples' export step also takes JAX's trained model (a whole
JAX training run is not matched: float training drifts over many steps)
and must give JAX's artifact fingerprint."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.core import snn
from repro_torch.data import mnist
from repro_torch.training import ttfs_trainer

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
NAMES = ("torch_quickstart", "torch_train_ttfs_mnist", "torch_serve_lm",
         "torch_train_lm", "torch_elastic_restart")
#: each example's smallest setting on the CPU
SMALL = {
    "torch_quickstart": ["--n-train", "512", "--n-test", "256"],
    "torch_train_ttfs_mnist": ["--quick", "--limit", "512", "--epochs", "1"],
    "torch_serve_lm": ["--requests", "4", "--max-new", "4"],
    "torch_train_lm": ["--steps", "4", "--batch", "2", "--seq", "16",
                       "--ckpt-every", "2"],
    "torch_elastic_restart": [],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the examples' small CPU
    products gain nothing from more, and when the suite's other workers
    hold the cores, a pool of threads waiting on each other made a test
    30 times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu(name, *extra):
    return SMALL[name] + list(extra) + ["--device", "cpu"]


def test_quickstart_agrees_three_ways(tmp_path):
    got = example("torch_quickstart").main(
        cpu("torch_quickstart", "--out", str(tmp_path)))
    assert got["n_images"] == 256
    assert got["agreement"] == {"accelerator": True, "board-emu": True}
    assert 0.0 < got["accuracy"] <= 1.0
    assert os.path.exists(got["path"])


def test_train_ttfs_mnist_holds_the_papers_protocol(tmp_path):
    got = example("torch_train_ttfs_mnist").main(
        cpu("torch_train_ttfs_mnist", "--out", str(tmp_path)))
    rep = got["agreement"]
    assert rep.exact_match and rep.n_images == 512
    assert all(v == 0 for v in rep.label_mismatches.values())
    assert all(v == 0 for v in rep.spike_time_mismatches.values())
    r = got["repeatability"]
    assert r["mismatches"] == 0 and r["image_run_pairs"] == 5 * 512
    assert r["accuracy_stable"]
    assert list(got["sparsity"]) == [0.0, 0.25, 0.5, 0.75]
    assert got["steps"] == 2                 # 512 images, batch 256


#: (example, the training images it exports from, its calibration images)
EXPORTS = {"torch_quickstart": ((512, 1), 2048),
           "torch_train_ttfs_mnist": ((512, 1234), 8192)}


@pytest.mark.parametrize("name", list(EXPORTS))
def test_export_of_jax_trained_model_gives_jax_fingerprint(name, tmp_path):
    from repro.core import deploy as jdeploy
    from repro.training import ttfs_trainer as jtrainer
    (n, seed), n_calib = EXPORTS[name]
    xtr, ytr = mnist.generate(n, seed)
    jres = jtrainer.train_dense_proxy(xtr, ytr, epochs=1)
    want = jdeploy.export(jres.model, str(tmp_path / "jax.npz"),
                          calib_images=xtr[:n_calib],
                          calib_labels=ytr[:n_calib])
    w = np.array(jres.model.body.layers[0].params["w"], np.float32)
    model = ttfs_trainer._model(torch.from_numpy(w), snn.ReadoutSpec(), 32,
                                torch.device("cpu"))
    got = example(name).export_artifact(model, str(tmp_path / "port.npz"),
                                        xtr, ytr, "cpu")
    assert got.fingerprint() == want.fingerprint()
    assert got.meta == want.meta


def test_serve_lm_serves_every_request():
    got = example("torch_serve_lm").main(cpu("torch_serve_lm"))
    assert [len(o) for o in got["outputs"]] == [4] * 4
    assert got["tokens"] == 16 and got["stats"]["tokens_out"] == 16
    st = got["stats"]
    assert 0 < st["accelerator_s"] <= st["system_s"]


def test_train_lm_resumes_where_a_run_never_stopped_ends(tmp_path):
    mod = example("torch_train_lm")
    first = mod.main(cpu("torch_train_lm", "--ckpt-dir", str(tmp_path / "a")))
    assert first["start"] == 0 and first["checkpoints"] == [2, 4]
    six = ["--steps", "6", "--device", "cpu"]   # the later flags win
    resumed = mod.main(cpu("torch_train_lm", "--ckpt-dir",
                           str(tmp_path / "a")) + six)
    whole = mod.main(cpu("torch_train_lm", "--ckpt-dir",
                         str(tmp_path / "b")) + six)
    assert resumed["start"] == 4 and whole["start"] == 0
    assert resumed["checkpoints"] == whole["checkpoints"] == [4, 6]
    for key in ("loss", "grad_norm"):
        assert torch.equal(resumed["metrics"][key], whole["metrics"][key])
    assert np.isfinite(float(whole["metrics"]["loss"]))


def test_elastic_restart_replays_the_uninterrupted_run(tmp_path):
    got = example("torch_elastic_restart").main(
        cpu("torch_elastic_restart", "--ckpt-dir", str(tmp_path)))
    assert got["bit_identical"] and got["restored_at"] == 5
    assert got["moved"] == [0, 1, 5, 7, 10]
    assert got["stragglers"] == ["h2*"]
    assert abs(sum(got["shares"].values()) - 1.0) < 1e-9


@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_cuda(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"torch_quickstart": ["--n-train", "64", "--n-test", "64",
                                 "--out", str(tmp_path)],
            "torch_train_ttfs_mnist": ["--quick", "--limit", "64", "--out",
                                       str(tmp_path)],
            "torch_serve_lm": SMALL[name],
            "torch_train_lm": SMALL[name] + ["--ckpt-dir", str(tmp_path)],
            "torch_elastic_restart": ["--ckpt-dir", str(tmp_path)]}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example(name).main(argv)
