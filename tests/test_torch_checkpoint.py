"""The port's checkpoints and elastic primitives on the CPU against the JAX
package's: ``repro_torch.training.checkpoint.CheckpointManager`` writes
JAX's on-disk format (keys, file names, manifest byte for byte), each
package restores the other's train state, corruption is caught, old steps
are pruned and the fsync order is JAX's; ``repro_torch.training.elastic``
gives JAX's assignments, moves and straggler verdicts."""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import LM as JLM
from repro.training import elastic as jelastic, lm_step as jstep, optim as jO
from repro.training.checkpoint import CheckpointManager as JManager
from repro_torch.configs import registry
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.training import elastic, lm_step, optim as O
from repro_torch.training.checkpoint import CheckpointManager

ARCH = "yi-6b"


@pytest.fixture(scope="module")
def state():
    """The reduced model's JAX parameters and Adafactor state after one
    step (its factored leaves among them), and the port's copies of both."""
    cfg_j = jregistry.reduced(jregistry.get_config(ARCH))
    cfg_t = registry.reduced(registry.get_config(ARCH))
    jlm = JLM(cfg_j)
    params = jlm.init_params(jax.random.PRNGKey(3), jnp.float32)
    opt = jO.adafactor(lr=1e-3)
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (2, 16)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    params, jopt, _ = jax.jit(jstep.make_train_step(jlm, opt))(
        params, opt.init(params), jax.tree.map(jnp.asarray, batch))
    params, jopt = jax.device_get((params, jopt))
    lm = lm_from_jax(cfg_t, params, device="cpu")
    # the port's layout: each slot keyed by the leaf's "/"-joined path
    topt = {"step": int(jopt["step"]), "f": {}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jopt["f"])[0]:
        key = "/".join(str(k.key) for k in path[:-1])
        topt["f"].setdefault(key, {})[path[-1].key] = torch.from_numpy(
            np.array(leaf))
    return cfg_t, params, jopt, lm, topt


def _files(d):
    return sorted(os.listdir(d))


def test_manifests_are_byte_equal_for_the_same_tree(state, tmp_path):
    cfg, params, jopt, lm, topt = state
    meta = {"loss": 1.5, "arch": cfg.name}
    jdir = JManager(str(tmp_path / "jax"), keep=2).save(
        1, {"params": params, "opt": jopt}, meta=meta)
    tdir = CheckpointManager(str(tmp_path / "torch"), keep=2).save(
        1, {"params": lm_to_jax(lm), "opt": topt}, meta=meta)
    assert _files(jdir) == _files(tdir)
    for name in _files(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_each_package_restores_the_others_checkpoint(state, tmp_path):
    cfg, params, jopt, lm, topt = state
    # the port reads JAX's
    JManager(str(tmp_path / "jax")).save(7, {"params": params, "opt": jopt})
    fresh = lm_from_jax(cfg, jax.tree.map(np.zeros_like, params),
                        device="cpu")
    zero_opt = lm_step.make_opt_state(fresh, O.adafactor())
    step, got = CheckpointManager(str(tmp_path / "jax")).restore(
        {"params": lm_to_jax(fresh), "opt": zero_opt}, device="cpu")
    assert step == 7 and got["opt"]["step"] == int(jopt["step"])
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for key, leaf in topt["f"].items():
        for slot, t in leaf.items():
            assert torch.equal(got["opt"]["f"][key][slot], t), (key, slot)
    # and JAX reads the port's
    CheckpointManager(str(tmp_path / "torch")).save(
        9, {"params": lm_to_jax(lm), "opt": topt})
    target = jax.tree.map(np.zeros_like, {"params": params, "opt": jopt})
    step, back = JManager(str(tmp_path / "torch")).restore(target)
    assert step == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": params, "opt": jopt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_corruption_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(8, dtype=torch.float32), "step": 3})
    d = os.path.join(str(tmp_path), "step_0000000001")
    victim = next(f for f in os.listdir(d) if f.endswith(".npy"))
    a = np.load(os.path.join(d, victim))
    a.flat[0] += 1
    np.save(os.path.join(d, victim), a)
    target = {"w": torch.zeros(8), "step": 0}
    with pytest.raises(IOError, match="corrupt"):
        mgr.restore(target, device="cpu")
    mgr.restore(target, device="cpu", verify=False)


def test_restore_refuses_a_missing_or_misshapen_array(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"w": torch.zeros(4), "b": torch.zeros(1)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(5)}, device="cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(2, {"w": torch.zeros(4, dtype=torch.bfloat16)})


def test_restore_needs_a_card_unless_told(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.restore({"w": torch.zeros(4)})


def test_prunes_and_lists(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((3,), float(s))}, meta={"s": s})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert mgr.meta(3) == {"s": 3}
    step, got = mgr.restore({"w": torch.zeros(3)}, device="cpu")
    assert step == 4 and torch.equal(got["w"], torch.full((3,), 4.0))
    assert CheckpointManager(str(tmp_path / "none")).latest_step() is None


def test_checkpoint_durability_ordering(tmp_path, monkeypatch):
    """As JAX's (tests/test_training.py): every payload file and the tmp
    directory entry fsynced BEFORE the atomic os.replace, the parent
    directory AFTER it."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def spy_fsync(fd):
        events.append(("fsync", os.fstat(fd).st_mode & 0o170000))
        return real_fsync(fd)

    def spy_replace(src, dst):
        events.append(("replace", src, dst))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    monkeypatch.setattr(os, "replace", spy_replace)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32), "b": np.zeros(2)}
    mgr.save(1, tree)
    kinds = [e[0] for e in events]
    assert kinds.count("replace") == 1
    rep = kinds.index("replace")
    pre, post = events[:rep], events[rep + 1:]
    assert len([e for e in pre if e == ("fsync", stat.S_IFREG)]) == \
        len(tree) + 1                                 # arrays + manifest
    assert len([e for e in pre if e == ("fsync", stat.S_IFDIR)]) == 1
    assert post == [("fsync", stat.S_IFDIR)]
    step, back = mgr.restore({"w": torch.zeros(6), "b": np.zeros(2)},
                             device="cpu")
    assert step == 1 and torch.equal(back["w"], tree["w"])


# ------------------------------------------------------------------ elastic
@pytest.mark.parametrize("n_hosts,n_shards", [(3, 17), (8, 64), (5, 200)])
def test_assignment_and_rebalance_equal_jax(n_hosts, n_shards):
    hosts = [f"host{i}" for i in range(n_hosts)]
    a = elastic.shard_assignment(hosts, n_shards)
    assert a == jelastic.shard_assignment(hosts, n_shards)
    live = hosts[1:]
    assert elastic.rebalance(a, live) == jelastic.rebalance(a, live)


def test_straggler_monitor_equals_jax():
    rng = np.random.RandomState(4)
    mons = (elastic.StragglerMonitor(window=8, threshold=1.4),
            jelastic.StragglerMonitor(window=8, threshold=1.4))
    hosts = [f"h{i}" for i in range(5)]
    for step in range(30):
        for h in hosts:
            t = float(rng.rand()) + (2.0 if h == "h3" and step > 10 else 0.5)
            for m in mons:
                m.record(h, t)
    assert mons[0].stragglers() == mons[1].stragglers() == ["h3"]
    assert mons[0].work_shares(hosts) == mons[1].work_shares(hosts)
