"""The port's expert-parallel MoE (``repro_torch.models.moe.
moe_ffn_shard_map``) and ``LM``'s guard for it, against JAX's shard_map on
the CPU.

The port runs in gloo process groups of 1, 2 and 4 ranks (meshes data x
model 1x1, 1x2, 1x4 and 2x2; ``_torch_shard_map_worker.py``), each in
subprocesses under a time limit, rendezvous through a file: a process group
is global to a process, so none is made in this one. JAX runs its
``moe_ffn_shard_map`` on 4 placeholder devices in a subprocess of its own
(``_torch_shard_map_jax.py``) on the same inputs: the reduced Qwen3-MoE and
Jamba sublayers (E 4, top-2, d 64) at capacity factor 1.0, where
assignments drop.

Routing (``top_i``, ``keep``) is held exactly; outputs within 1e-5 of JAX's
shard_map and of JAX's ``moe_ffn`` on the same rows; aux within 1e-6;
gradients within 1e-5 of the largest |gradient| of JAX's. Aux is JAX's on
both faults of the reference (ROADMAP §3): the first data shard's value in
the forward, the gradient of the data shards' mean aux in the backward. At
a model dim of 1 the port is ``moe_ffn`` bit for bit."""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.distributed.sharding import make_constrainer
from repro_torch.models import moe
from repro_torch.models.model import LM

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.normpath(os.path.join(HERE, "..", "src"))
WORKER = os.path.join(HERE, "_torch_shard_map_worker.py")
JAX_SIDE = os.path.join(HERE, "_torch_shard_map_jax.py")
ARCHS = ("qwen3-moe-235b-a22b", "jamba-1.5-large-398b")
#: mesh name -> (data, model); JAX runs all but 1x1
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SHARDED = ("1x2", "1x4", "2x2")
NAMES = ("router", "w_gate", "w_up", "w_down")
B, S = 4, 32
OUT_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
#: every subprocess of the module, all started at once, must end in this
TIMEOUT_S = 120


def _inputs() -> dict:
    """The two reduced MoE sublayers' x and weights, float32 from seeds; a
    router scale of 0.3 loads some experts past capacity."""
    out = {}
    for seed, arch in enumerate(ARCHS):
        cfg = reduced(get_config(arch))
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        rng = np.random.RandomState(10 + seed)
        out[f"{arch}_x"] = rng.randn(B, S, d).astype(np.float32)
        out[f"{arch}_router"] = (rng.randn(d, E) * 0.3).astype(np.float32)
        for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                            ("w_down", (E, f, d))):
            out[f"{arch}_{name}"] = (rng.randn(*shape) /
                                     np.sqrt(shape[1])).astype(np.float32)
        out[f"{arch}_meta"] = np.array(json.dumps(
            dict(E=E, k=cfg.top_k, capacity_factor=1.0)))
    return out


def _finish(procs: dict) -> None:
    """Wait for every process, all under one deadline; a process that fails
    or outlives it fails the test (and the others are killed)."""
    deadline = time.monotonic() + TIMEOUT_S
    failed = []
    try:
        for name, p in procs.items():
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                failed.append(f"{name}: no end within {TIMEOUT_S} s")
                continue
            if p.returncode != 0:
                failed.append(f"{name}: rc {p.returncode}\n"
                              f"{out.decode(errors='replace')[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n".join(failed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX's results, mesh name: [each rank's results]}."""
    inputs = _inputs()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs, dirs = {}, {}
    for name, shape in [("jax", None)] + list(MESHES.items()):
        d = tmp_path_factory.mktemp(f"shard_map_{name}")
        np.savez(d / "inputs.npz", **inputs)
        dirs[name] = d
        if shape is None:
            procs[name] = subprocess.Popen(
                [sys.executable, JAX_SIDE, str(d)], env=dict(
                    env, OMP_NUM_THREADS="2"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            continue
        data, model = shape
        world = data * model
        for r in range(world):
            procs[f"{name} rank {r}"] = subprocess.Popen(
                [sys.executable, WORKER, str(d), str(r), str(world),
                 f"{data},{model}", "data,model"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    _finish(procs)
    out = {"jax": dict(np.load(dirs["jax"] / "jax.npz"))}
    for name, (data, model) in MESHES.items():
        out[name] = [dict(np.load(dirs[name] / f"rank{r}.npz"))
                     for r in range(data * model)]
    return out


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, f"{what}: max |err| {err:.3g} > {tol:.3g}"


# ----------------------------------------------------------- the sublayer
@pytest.mark.parametrize("arch", ARCHS)
def test_assignments_drop_at_capacity_factor_one(arch, runs):
    """The inputs drop assignments, so the shards must drop the same ones:
    ``pos`` runs over all E experts on every rank."""
    keep = runs["jax"][f"{arch}_keep"]
    assert (~keep).sum() > 0
    for name in SHARDED:
        for z in runs[name]:
            a, b = z[f"{arch}_rows"]
            np.testing.assert_array_equal(z[f"{arch}_keep"], keep[a:b])


@pytest.mark.parametrize("mesh", SHARDED)
@pytest.mark.parametrize("arch", ARCHS)
def test_sublayer_equals_jax_shard_map(arch, mesh, runs):
    """Each rank's routing exactly JAX's, its rows of the output within
    1e-5 of JAX's shard_map and of JAX's moe_ffn, and its aux JAX's: the
    first data shard's."""
    J = runs["jax"]
    tag = f"{arch}_{mesh}"
    for r, z in enumerate(runs[mesh]):
        a, b = z[f"{arch}_rows"]
        np.testing.assert_array_equal(z[f"{arch}_top_i"],
                                      J[f"{arch}_top_i"][a:b])
        np.testing.assert_array_equal(z[f"{arch}_keep"],
                                      J[f"{arch}_keep"][a:b])
        _close(z[f"{arch}_y"], J[f"{tag}_y"][a:b], OUT_TOL,
               f"rank {r} output against JAX's shard_map")
        _close(z[f"{arch}_y"], J[f"{arch}_moe_y"][a:b], OUT_TOL,
               f"rank {r} output against JAX's moe_ffn")
        _close(z[f"{arch}_aux"], J[f"{tag}_aux"], AUX_TOL,
               f"rank {r} aux against JAX's shard_map")
        _close(z[f"{arch}_aux"], J[f"{tag}_shard_aux"][0], AUX_TOL,
               f"rank {r} aux against moe_ffn on the first data shard")


@pytest.mark.parametrize("mesh", SHARDED)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_equal_jax_grad_through_shard_map(arch, mesh, runs):
    """Gradients of sum(y**2) and of aux: x's on the rank's rows, the
    router's whole, each expert slice's on the rank that owns it, within
    1e-5 of the largest |gradient| of ``jax.grad`` through JAX's shard_map
    (each replicated input's gradient summed over its dims)."""
    J = runs["jax"]
    tag = f"{arch}_{mesh}"
    for g in ("gy", "ga"):
        for name in ("x",) + NAMES:
            want = J[f"{tag}_{g}_{name}"]
            tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-3)
            for r, z in enumerate(runs[mesh]):
                if name == "x":
                    a, b = z[f"{arch}_rows"]
                elif name == "router":
                    a, b = 0, want.shape[0]
                else:
                    a, b = z[f"{arch}_experts"]
                _close(z[f"{arch}_{g}_{name}"], want[a:b], tol,
                       f"rank {r} {g} d{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_is_the_first_shard_forward_and_the_data_mean_backward(arch,
                                                                   runs):
    """The two faults of the reference, on the 2x2 mesh: the forward's aux
    is the first data shard's, not the batch's, and its gradient is that of
    the mean over data shards of each shard's aux, in JAX and in the
    port."""
    J = runs["jax"]
    tag = f"{arch}_2x2"
    shard_aux = J[f"{tag}_shard_aux"]
    assert abs(float(J[f"{arch}_moe_aux"]) - shard_aux[0]) > 1e-3
    assert abs(float(J[f"{tag}_aux"]) - shard_aux[0]) <= AUX_TOL
    for name in ("x", "router"):
        want = J[f"{tag}_mean_ga_{name}"]
        tol = GRAD_TOL * float(np.abs(want).max())
        _close(J[f"{tag}_ga_{name}"], want, tol, f"JAX's d{name}")
        for z in runs["2x2"]:
            a, b = z[f"{arch}_rows"] if name == "x" else (0, want.shape[0])
            _close(z[f"{arch}_ga_{name}"], want[a:b], tol,
                   f"the port's d{name}")


@pytest.mark.parametrize("mesh", SHARDED)
def test_each_rank_reads_only_its_own_experts(mesh, runs):
    """Every expert a rank does not own is NaN there; its output, aux and
    gradients are finite, and its foreign experts get no gradient."""
    for z in runs[mesh]:
        for arch in ARCHS:
            for key in ("y", "aux") + tuple(
                    f"{g}_{n}" for g in ("gy", "ga") for n in ("x",) + NAMES):
                assert np.isfinite(z[f"{arch}_{key}"]).all(), (arch, key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_dim_of_one_is_moe_ffn_bit_for_bit(arch, dtype, runs):
    (z,) = runs["1x1"]
    for what in ("y", "aux"):
        same, same_dtype = z[f"{arch}_{dtype}_{what}_bits"]
        assert same and same_dtype, what


# ----------------------------------------------------------- LM's guard
def _calls(z, key):
    return json.loads(str(z[key]))


def _moe_sublayers(arch) -> int:
    cfg = reduced(get_config(arch))
    return sum(cfg.is_moe_layer(i) for i in range(len(cfg.period))) \
        * cfg.n_periods


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_takes_the_shard_map_where_the_model_dim_divides_e(arch, mesh,
                                                              runs):
    """``moe_buf_mode="shard_map"`` with the mesh's constrainer: every MoE
    sublayer runs moe_ffn_shard_map where the model dim divides E (4
    experts everywhere, 6 on model dims 1 and 2), and the logits stay
    within 1e-5 of the same LM without a mesh (bit for bit on one rank);
    aux is the first data shard's."""
    model = MESHES[mesh][1]
    ranks = runs[mesh]
    for E in (4, 6):
        if E % model:
            continue
        for dt in ("float32", "bfloat16"):
            key = f"{arch}_lm_E{E}_{dt}"
            first_aux = ranks[0][f"{key}_aux"][1]
            for z in ranks:
                calls = _calls(z, f"{key}_calls")
                assert calls == {"moe_ffn_shard_map": _moe_sublayers(arch),
                                 "moe_ffn": 0}, calls
                assert _calls(z, f"{key}_plain_calls")["moe_ffn_shard_map"] \
                    == 0
                if mesh == "1x1":
                    assert bool(z[f"{key}_bits"]), key
                tol = OUT_TOL if dt == "float32" else 2e-2
                assert float(z[f"{key}_err"]) <= tol, key
                assert abs(z[f"{key}_aux"][0] - first_aux) <= \
                    (AUX_TOL if dt == "float32" else 2e-2), key


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_takes_local_moe_ffn_where_the_model_dim_does_not_divide_e(
        arch, runs):
    """6 experts on a model dim of 4: moe_ffn with buf_mode "local", as
    JAX's guard, and logits bit for bit the LM's without a mesh."""
    for z in runs["1x4"]:
        for dt in ("float32", "bfloat16"):
            key = f"{arch}_lm_E6_{dt}"
            assert _calls(z, f"{key}_calls") == {
                "moe_ffn_shard_map": 0, "moe_ffn": _moe_sublayers(arch),
                "buf_mode": "local"}
            assert bool(z[f"{key}_bits"]), key


def _mesh_stand_in(sizes, names=("data", "model"), device_type="cpu"):
    """What the guard and the argument checks read of a DeviceMesh."""
    return types.SimpleNamespace(
        mesh_dim_names=names, device_type=device_type,
        size=lambda dim=None: (int(np.prod(sizes)) if dim is None
                               else sizes[dim]))


def test_mixtral_on_the_production_mesh_takes_local_moe_ffn():
    """Mixtral's 8 experts on the production mesh's model dim of 16: the
    guard takes moe_ffn "local" and no collective is issued."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              n_experts=8, moe_buf_mode="shard_map")
    lm = LM(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 16)))
    plain, _ = lm.forward(toks)
    lm.constrain = make_constrainer(_mesh_stand_in((16, 16)))
    modes, real = [], moe.moe_ffn

    def counted(*args, **kw):
        modes.append(kw.get("buf_mode"))
        return real(*args, **kw)

    moe.moe_ffn = counted
    try:
        got, _ = lm.forward(toks)
    finally:
        moe.moe_ffn = real
    assert modes == ["local"] * cfg.n_layers
    assert torch.equal(got, plain)


def test_shard_map_refuses_what_it_cannot_run(monkeypatch):
    """A model dim that does not divide E, x off the mesh's device type,
    and a "cuda" mesh without a card each raise before any collective."""
    x = torch.zeros(1, 4, 8)
    p = {"router": torch.zeros(8, 6), "w_gate": torch.zeros(6, 8, 4),
         "w_up": torch.zeros(6, 8, 4), "w_down": torch.zeros(6, 4, 8)}
    kw = dict(n_experts=6, top_k=2, capacity_factor=1.0)
    with pytest.raises(ValueError, match="do not divide"):
        moe.moe_ffn_shard_map(x, p, mesh=_mesh_stand_in((1, 4)), **kw)
    with pytest.raises(ValueError, match="lies on"):
        moe.moe_ffn_shard_map(x, p, mesh=_mesh_stand_in(
            (1, 2), device_type="meta"), **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe.moe_ffn_shard_map(x, p, mesh=_mesh_stand_in(
            (1, 2), device_type="cuda"), **kw)
