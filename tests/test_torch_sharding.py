"""The port's sharding rules (``repro_torch.distributed.sharding``) and mesh
builders (``repro_torch.launch.mesh``) against the JAX package's.

The rules read only a mesh's names and sizes, so JAX's side runs on its
tests' ``MockMesh`` and the port's on its own ``Mesh`` record. Specs compare
as tuples (``tuple(port_spec) == tuple(jax_spec)``). Parameter trees are
JAX's ``LM.param_specs()`` and the port's ``leaf_groups`` of an ``LM`` on the
meta device, compared leaf by leaf by JAX's path; optimiser states are each
package's ``init`` of those. The production meshes are built over the fake
process group (world 256 and 512) in a subprocess: a process group is
global to a process."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ALIASES, get_config as jget
from repro.distributed import sharding as JS
from repro.models.model import LM as JLM
from repro.training import optim as JO
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models.convert import leaf_groups
from repro_torch.models.model import LM
from repro_torch.training import optim as O

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.normpath(os.path.join(HERE, "..", "src"))
ARCHS = list(ALIASES)


@dataclasses.dataclass
class MockMesh:
    shape: dict
    axis_names: tuple


SINGLE = MockMesh({"data": 16, "model": 16}, ("data", "model"))
MULTI = MockMesh({"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"))
TEST = MockMesh({"data": 2, "model": 2}, ("data", "model"))
TP4 = MockMesh({"data": 64, "model": 4}, ("data", "model"))
MESHES = {"single": SINGLE, "multi": MULTI, "test": TEST, "tp4": TP4}


def port(mesh: MockMesh) -> SH.Mesh:
    return SH.Mesh(tuple(mesh.axis_names),
                   tuple(mesh.shape[a] for a in mesh.axis_names))


def jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {JS.path_str(p): tuple(s) for p, s in flat}


def tflat(tree) -> dict:
    return {k: tuple(v) for k, v in SH.flatten(tree).items()}


@pytest.fixture(scope="module")
def trees():
    """arch -> (JAX's abstract params, the port's meta params by path)."""
    out = {}
    for arch in ARCHS:
        lm = LM(get_config(arch), device="meta")
        out[arch] = (JLM(jget(arch)).param_specs(),
                     {g.path: g.leaf for g in leaf_groups(lm)})
    return out


# ------------------------------------------------------------ the resolver
def test_resolve_axis_divisibility():
    """JAX's cases, on both packages."""
    for mod, single, multi in ((JS, SINGLE, MULTI),
                               (SH, port(SINGLE), port(MULTI))):
        assert mod.resolve_axis(single, 64, "model") == "model"
        assert mod.resolve_axis(single, 40, "model") is None
        assert mod.resolve_axis(single, 40, ("model", None)) is None
        assert mod.resolve_axis(multi, 64, "data") == ("pod", "data")
        assert mod.resolve_axis(multi, 48, "data") is None


def test_spec_no_axis_reuse_and_gqa_fallback():
    s = SH.spec(port(SINGLE), (16, 16), ("model", "model"))
    assert s == SH.Spec("model", None) and tuple(s) == tuple(P("model", None))
    s = SH.spec(port(SINGLE), (32, 128, 8, 1024, 128),
                (None, "data", ("model", None), None, "model"))
    assert tuple(s) == tuple(P(None, "data", None, None, "model"))


LOGICAL = st.sampled_from([None, "model", "data", "pod", ("model", None),
                           ("data", None), ("model", "data"),
                           ("data", "model", None)])
DIMS = st.sampled_from([1, 2, 3, 4, 8, 16, 24, 32, 40, 48, 64, 96, 128,
                        256, 4096, 51865, 92553])


@settings(max_examples=60, deadline=None)
@given(st.sampled_from(list(MESHES)),
       st.lists(st.tuples(DIMS, LOGICAL), min_size=1, max_size=5))
def test_spec_equals_jax(mesh, dims):
    shape = tuple(d for d, _ in dims)
    logical = tuple(lg for _, lg in dims)
    m = MESHES[mesh]
    assert tuple(SH.spec(port(m), shape, logical)) == \
        tuple(JS.spec(m, shape, logical))
    for d, lg in dims:
        assert SH.resolve_axis(port(m), d, lg) == JS.resolve_axis(m, d, lg)


@settings(max_examples=40, deadline=None)
@given(st.sampled_from(list(MESHES)),
       st.lists(st.lists(DIMS, min_size=0, max_size=4), min_size=1,
                max_size=4))
def test_batch_pspec_equals_jax(mesh, shapes):
    m = MESHES[mesh]
    jtree = {f"b{i}": jax.ShapeDtypeStruct(tuple(s), jnp.int32)
             for i, s in enumerate(shapes)}
    ttree = {f"b{i}": torch.empty(tuple(s), device="meta")
             for i, s in enumerate(shapes)}
    assert tflat(SH.batch_pspec(port(m), ttree)) == \
        jflat(JS.batch_pspec(m, jtree))


# -------------------------------------------------------- parameter rules
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(arch, trees):
    """Every leaf's spec JAX's, on the production meshes and the test and
    TP-4 ones, with and without FSDP and in both FSDP modes."""
    jtree, ttree = trees[arch]
    for m in MESHES.values():
        for kw in ({}, {"fsdp": False}, {"fsdp_mode": "stack"}):
            want = jflat(JS.param_pspecs(m, jtree, **kw))
            got = tflat(SH.param_pspecs(port(m), ttree, **kw))
            assert got == want, (arch, m.shape, kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_cover_every_leaf_legally(arch, trees):
    """JAX's coverage test on the port: every named axis divides its dim,
    and every leaf of at least 4M elements is sharded on the single-pod
    mesh."""
    _, ttree = trees[arch]
    mesh = port(SINGLE)
    for path, s in SH.flatten(SH.param_pspecs(mesh, ttree)).items():
        leaf = ttree[path]
        for d, ax in zip(leaf.shape, s):
            assert ax is None or d % SH.axis_size(mesh, ax) == 0, (path, s)
        if leaf.numel() >= 1 << 22:
            assert any(a is not None for a in s), (path, leaf.shape, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimiser_state_pspecs_equal_jax(arch, trees):
    """AdamW's and Adafactor's (and SGD's) states of the same trees, laid
    out by the parameter rules as JAX's dry-run lays them out."""
    jtree, ttree = trees[arch]
    for name in ("adamw", "adafactor", "sgd"):
        jstate = jax.eval_shape(JO.get(name, 3e-4).init, jtree)
        tstate = O.get(name, 3e-4).init(ttree)
        for m in (SINGLE, MULTI):
            for kw in ({}, {"fsdp": False}, {"fsdp_mode": "stack"}):
                want = jflat(JS.param_pspecs(m, jstate, **kw))
                got = tflat(SH.param_pspecs(port(m), tstate, **kw))
                assert got == want, (arch, name, m.shape, kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_jax(arch):
    """Every arch's decode cache (batch 128 and 1, a 32,768-token window),
    at both ``seq_shard`` settings."""
    cfg_j, cfg_t = jget(arch), get_config(arch)
    lm = LM(cfg_t, device="meta")
    enc = cfg_t.cross_len if cfg_t.enc_layers else None
    for B in (128, 1):
        jcache = JLM(cfg_j).init_cache(B, 32768, dtype=jnp.bfloat16,
                                       abstract=True, enc_len=enc)
        tcache = lm.init_cache(B, 32768, enc_len=enc)
        for m in (SINGLE, MULTI, TEST):
            for seq_shard in (False, True):
                want = jflat(JS.cache_pspecs(m, jcache, seq_shard=seq_shard))
                got = tflat(SH.cache_pspecs(port(m), tcache,
                                            seq_shard=seq_shard))
                assert got == want, (arch, B, m.shape, seq_shard)


def test_tp_only_fits_equals_jax():
    for arch in ARCHS:
        for opt in ("adamw", "adafactor", "sgd"):
            cj = dataclasses.replace(jget(arch), optimizer=opt)
            ct = dataclasses.replace(get_config(arch), optimizer=opt)
            for m in MESHES.values():
                for hbm in (16 * 2**30, 80 * 2**30):
                    assert SH.tp_only_fits(ct, port(m), hbm) == \
                        JS.tp_only_fits(cj, m, hbm), (arch, opt, m.shape)


# ------------------------------------------------------- placements, meshes
def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port(MULTI)
    assert SH.to_placements(mesh, SH.Spec(("pod", "data"), "model")) == \
        [Shard(0), Shard(0), Shard(1)]
    assert SH.to_placements(mesh, SH.Spec(None, "data")) == \
        [Replicate(), Shard(1), Replicate()]
    assert SH.to_placements(mesh, SH.Spec()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        SH.to_placements(mesh, SH.Spec(("data", "pod")))


@pytest.fixture(scope="module")
def fake_meshes():
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_fake_mesh.py")],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("which", ["single", "multi"])
def test_production_mesh_has_jax_names_and_sizes(which, fake_meshes):
    got = fake_meshes[which]
    names, sizes = {"single": (["data", "model"], [16, 16]),
                    "multi": (["pod", "data", "model"], [2, 16, 16])}[which]
    assert got["names"] == names and got["sizes"] == sizes
    assert got["record"] == [names, sizes]


@pytest.mark.parametrize("which", ["single", "multi"])
def test_placements_give_jax_local_shapes(which, fake_meshes, trees):
    """On the fake group, every parameter's DTensor local shape is its
    global shape divided as JAX's spec divides it."""
    m = {"single": SINGLE, "multi": MULTI}[which]
    got = fake_meshes[which]["params"]
    for arch in ARCHS:
        want = jflat(JS.param_pspecs(m, trees[arch][0]))
        assert set(got[arch]) == set(want), arch
        for path, (shape, _, local) in got[arch].items():
            div = [JS.axis_size(m, e) for e in want[path]]
            assert local == [d // n for d, n in zip(shape, div)], \
                (arch, path, want[path])
            assert all(d % n == 0 for d, n in zip(shape, div))


def test_a_dtensor_laid_out_on_the_fake_group(fake_meshes):
    """(64, 32) with rows on the data axes and columns on "model": each
    rank holds 64 / 16 x 32 / 16 (single pod) or 64 / 32 x 32 / 16."""
    assert fake_meshes["single"]["dtensor"] == [[4, 2], ["S(0)", "S(1)"]]
    assert fake_meshes["multi"]["dtensor"] == [[2, 2],
                                               ["S(0)", "S(0)", "S(1)"]]


def test_the_constrainer_carries_the_mesh_and_changes_nothing():
    con = SH.make_constrainer("a mesh")
    x = torch.ones(4, 4)
    assert con(x, ("data", "model")) is x and con.mesh == "a mesh"


def test_mesh_builders_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (M.make_production_mesh,
                  lambda: M.make_production_mesh(multi_pod=True),
                  M.make_test_mesh,
                  lambda: M.build_mesh((1,), ("model",))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
