"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py`` and none of the port's examples (``examples/torch_*.py``)
imports JAX or the JAX package, and nothing falls back to the CPU on its
own when the card is missing."""

import ast
import os

import numpy as np
import pytest
import torch

import repro_torch.conformance
from repro_torch.configs.registry import get_config, reduced
from repro_torch.conformance import fuzz_case, golden, run_case
from repro_torch.core import deploy, snn
from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import lower
from repro_torch.core.reference import SNNReference
from repro_torch.launch import serve
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.snn_engine import SNNServeEngine
from repro_torch.training import ttfs_trainer

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
MNIST_ART = os.path.join(PORT, "assets", "mnist_ttfs.npz")
FORBIDDEN = ("jax", "jaxlib", "repro")


EXAMPLES = os.path.join(ROOT, "examples")


def _port_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for name in sorted(os.listdir(EXAMPLES)):
        if name.startswith("torch_") and name.endswith(".py"):
            yield os.path.join(EXAMPLES, name)
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield node.lineno, [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.lineno, [node.module]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, [str(node.args[0].value)]


def test_port_imports_neither_jax_nor_repro():
    bad, seen = [], 0
    for path in _port_files():
        seen += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for lineno, mods in _imported_modules(tree):
            for mod in mods:
                if mod.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, ROOT)}:{lineno} "
                               f"imports {mod}")
    assert seen > 15
    assert not bad, "the port must not import JAX or repro:\n" + \
        "\n".join(bad)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = Artifact.load(MNIST_ART)
    for make in (lambda: lower(art), lambda: SNNReference(art),
                 lambda: SNNServeEngine(art)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert lower(art, device="cpu").device == torch.device("cpu")


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    """The LM path: the model, its serving engine and the launcher refuse to
    fall back to the CPU; each runs there when asked for ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen3-8b"))
    lm = LM(cfg, dtype=torch.float32, device="cpu")
    for make in (lambda: LM(cfg), lambda: ServeEngine(lm),
                 lambda: serve.main(["--arch", "qwen3-8b", "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert ServeEngine(lm, device="cpu").lm.device == torch.device("cpu")
    assert lm.device == torch.device("cpu")


#: modules whose files the walk must reach (the authoring and export slice)
AUTHORING = ("core/quant.py", "core/codesign.py", "core/snn.py",
             "core/deploy.py", "configs/mnist_ttfs.py", "training/optim.py",
             "training/ttfs_trainer.py", "conformance/__init__.py",
             "conformance/fuzz.py", "conformance/oracles.py",
             "conformance/golden.py", "telemetry/export.py")


def test_walk_covers_the_ports_examples():
    walked = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {f"examples/torch_{n}.py" for n in (
        "quickstart", "train_ttfs_mnist", "serve_lm", "train_lm",
        "elastic_restart")} <= walked


def test_walk_covers_the_authoring_modules():
    walked = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(AUTHORING) <= walked


def test_conformance_does_not_import_transport_faults():
    """The oracles module does not import the fault-injecting transport
    proxy when it is imported: the ``transport`` oracle imports it, and the
    socket layer under it, inside the function (as the JAX package does).
    The package exports the proxy's names, JAX's, from the port's own
    module."""
    conf = os.path.join(PORT, "conformance")
    with open(os.path.join(conf, "oracles.py")) as f:
        tree = ast.parse(f.read())
    top = [node for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))]
    for node in top:
        mods = [a.name for a in node.names] + [getattr(node, "module", "")
                                               or ""]
        assert not any("transport" in m for m in mods), ast.dump(node)
    lazy = {node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node not in top}
    assert "repro_torch.conformance.transport_faults" in lazy
    assert repro_torch.conformance.transport_faults.__name__ == \
        "repro_torch.conformance.transport_faults"
    assert {"SCENARIOS", "FaultyProxy", "Scenario", "run_scenario",
            "run_suite"} <= set(repro_torch.conformance.__all__)
    assert len(repro_torch.conformance.SCENARIOS) == 27


#: modules whose files the walk must reach (the program I/O and transport
#: slice)
TRANSPORT = ("core/program_io.py", "distributed/__init__.py",
             "distributed/transport.py", "launch/mesh.py",
             "launch/cluster.py", "launch/serve.py",
             "conformance/transport_faults.py")


def test_walk_covers_the_transport_modules():
    walked = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(TRANSPORT) <= walked


def test_transport_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Deserialize, broadcast, distribute, fetch and the launcher's SNN
    roles refuse to fall back to the CPU; each runs there when asked."""
    from repro_torch.conformance import run_suite
    from repro_torch.core.program_io import (deserialize_program,
                                             serialize_program)
    from repro_torch.distributed.transport import fetch_program
    from repro_torch.launch.cluster import distribute_program
    from repro_torch.launch.mesh import broadcast_program

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = Artifact.load(MNIST_ART)
    prog = lower(art, device="cpu", cache=False)
    blob = serialize_program(prog)
    path = str(tmp_path / "envelope.json")
    for make in (lambda: deserialize_program(blob, art),
                 lambda: broadcast_program(art, leader=True),
                 lambda: broadcast_program(art, leader=False,
                                           fetch=lambda: blob),
                 lambda: distribute_program(art, path, role="leader"),
                 lambda: fetch_program("127.0.0.1", 1, art),
                 lambda: run_suite(blob, art, prog.fingerprint),
                 lambda: serve.main(["--snn-artifact", MNIST_ART,
                                     "--requests", "4"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert deserialize_program(blob, art, device="cpu",
                               cache=False).fingerprint == prog.fingerprint


def test_authoring_entry_points_raise_without_cuda(monkeypatch):
    """Define, train, export and check conformance: each refuses to fall
    back to the CPU, and runs there when asked for ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 784), np.float32)
    y = np.zeros(4, np.int32)
    model = snn.SNN(snn.Sequential(snn.Linear(
        784, 150, generator=torch.Generator().manual_seed(0), device="cpu"),
        snn.LIF()))
    case = fuzz_case(4)
    for make in (lambda: snn.Linear(784, 150),
                 lambda: ttfs_trainer.train_dense_proxy(x, y, epochs=1,
                                                        batch=4),
                 lambda: ttfs_trainer.train_surrogate(x, y, epochs=1,
                                                      batch=4),
                 lambda: deploy.export(model, calib_images=x,
                                       calib_labels=y),
                 lambda: run_case(case),
                 lambda: golden.check(seeds=[0]),
                 lambda: golden.compute_golden(0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    art = deploy.export(model, calib_images=x, calib_labels=y, device="cpu")
    assert lower(art, device="cpu").n_out == 150


#: modules whose files the walk must reach (the worker lanes and resilience
#: slice)
RESILIENCE = ("faults/__init__.py", "faults/plan.py", "faults/models.py",
              "faults/detect.py", "serving/scheduler.py",
              "serving/snn_engine.py", "kernels/common.py")


def test_walk_covers_the_resilience_modules():
    walked = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(RESILIENCE) <= walked


def test_resilience_entry_points_raise_without_cuda(monkeypatch):
    """Worker lanes, fault plans, the static lowering pass, the board's
    dynamic plans and the canary refuse to fall back to the CPU; each runs
    there when asked for ``device="cpu"``."""
    from repro_torch.board import SNNBoard
    from repro_torch.core.lowering import lower_with_faults
    from repro_torch.core.runtimes import make_runtime
    from repro_torch.faults import Canary, FaultPlan
    from repro_torch.serving.scheduler import ServingScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = Artifact.load(MNIST_ART)
    plan = FaultPlan.parse("seu_weight=2,seed=1")
    makes = (lambda **kw: ServingScheduler(art, workers=2, **kw),
             lambda **kw: ServingScheduler(art, faults="crash=0", **kw),
             lambda **kw: SNNServeEngine(art, workers=1, max_wait_us=500.0,
                                         resilience={"verify": True}, **kw),
             lambda **kw: make_runtime(art, "board-py",
                                       faults="fifo=2,stuck=1", **kw),
             lambda **kw: lower_with_faults(art, plan, **kw),
             lambda **kw: SNNBoard(art, faults=FaultPlan(stuck_groups=1),
                                   **kw),
             lambda **kw: Canary.from_artifact(art, **kw))
    for make in makes:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for make in makes:
        made = make(device="cpu")
        if hasattr(made, "close"):
            made.close()


#: modules whose files the walk must reach (distribution and analysis)
DISTRIBUTION = ("distributed/sharding.py", "distributed/analytic.py",
                "distributed/roofline.py", "launch/mesh.py", "core/hw.py",
                "models/moe.py")


def test_walk_covers_the_distribution_modules():
    walked = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(DISTRIBUTION) <= walked


def test_distribution_entry_points_raise_without_cuda(monkeypatch):
    """The mesh builders and the expert-parallel MoE refuse a card that is
    not there; the builders run over a CPU group when asked for
    ``device_type="cpu"`` (``tests/test_torch_sharding.py``), the MoE on a
    CPU mesh (``tests/test_torch_moe_shard_map.py``)."""
    import types

    from repro_torch.launch import mesh
    from repro_torch.models import moe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda_mesh = types.SimpleNamespace(device_type="cuda",
                                      mesh_dim_names=("data", "model"))
    x = torch.zeros(1, 4, 8)
    p = {"router": torch.zeros(8, 4), "w_gate": torch.zeros(4, 8, 4),
         "w_up": torch.zeros(4, 8, 4), "w_down": torch.zeros(4, 4, 8)}
    for make in (mesh.make_production_mesh,
                 lambda: mesh.make_production_mesh(multi_pod=True),
                 mesh.make_test_mesh,
                 lambda: mesh.build_mesh((2, 2), ("data", "model")),
                 lambda: moe.moe_ffn_shard_map(
                     x, p, n_experts=4, top_k=2, capacity_factor=1.0,
                     mesh=cuda_mesh)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
