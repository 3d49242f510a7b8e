"""LM training in the port on the CPU, against the JAX package: the
optimisers and gradient compression on a stacked tree, ``LM.loss`` and every
gradient leaf of four families, rematerialisation, the train step with each
optimiser, micro-batches and compression, the committed asset
``lm_train_expected.npz`` and the training launcher's resume.

Tolerances, each stated where it is used: the optimisers on the same
gradients within 1e-6; compression bit for bit; the loss within 1e-5 and
the gradients within 1e-4 (the same sums in another order, through a
softmax and the backward of attention); the train step's parameters within
1e-4 (the bound AdamW holds on the surrogate, ROADMAP §3) and its loss and
gradient norm within 1e-5; remat and the launcher's resume bit for bit."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.tokens import TokenPipeline as JPipeline
from repro.data.tokens import TokenPipelineConfig as JPipelineConfig
from repro.models.model import LM as JLM
from repro.training import compress as jC, lm_step as jstep, optim as jO
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch import train as launcher
from repro_torch.models.convert import (leaf_groups, lm_from_jax, lm_to_jax,
                                        nest)
from repro_torch.models.model import LM
from repro_torch.training import compress as C, lm_step, optim as O
from repro_torch.training.checkpoint import CheckpointManager

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSET = os.path.join(ROOT, "src", "repro_torch", "assets",
                     "lm_train_expected.npz")
OPT_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-4, 1e-4
FAMILIES = ("yi-6b", "qwen3-moe-235b-a22b", "mamba2-780m", "whisper-tiny")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _load("export_torch_fixture",
               os.path.join(ROOT, "scripts", "export_torch_fixture.py"))
SMOKE = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def _flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------- optimisers, compression
#: a stacked matrix, a stacked norm scale (JAX factors it across periods)
#: and a top-level vector
STACKED = {"blocks/0:attn/wq": (2, 64, 32), "blocks/0:attn/ln": (2, 32),
           "final_norm": (32,)}


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shape).astype(np.float32)
            for k, shape in STACKED.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimisers_equal_jax_on_a_stacked_tree(name):
    jopt, opt = jO.get(name, 1e-2), O.get(name, 1e-2)
    params = _tree(0)
    jp, jst = nest(params), None
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jst, st = jopt.init(jp), opt.init(tp)
    for step in range(3):
        grads = _tree(10 + step)
        jp, jst = jopt.update(nest(grads), jst, jp)
        tp, st = opt.update({k: torch.from_numpy(v) for k, v in
                             grads.items()}, st, tp)
    for k, v in _flat(jp).items():
        np.testing.assert_allclose(tp[k].numpy(), v, rtol=OPT_TOL,
                                   atol=OPT_TOL, err_msg=f"{name} {k}")
    want = _flat(jst)
    assert int(want.pop("step")) == st["step"] == 3
    got = {}
    for slot, leaves in st.items():
        if slot == "step":
            continue
        for k, s in leaves.items():
            for sub, t in (s.items() if isinstance(s, dict) else [(None, s)]):
                got["/".join(x for x in (slot, k, sub) if x)] = t
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), v, rtol=OPT_TOL,
                                   atol=OPT_TOL, err_msg=f"{name} {k}")


def test_adafactor_factors_a_stacked_norm_across_periods():
    st = O.adafactor().init({k: torch.zeros(s) for k, s in STACKED.items()})
    f = st["f"]
    assert f["blocks/0:attn/ln"]["vr"].shape == (2,)
    assert f["blocks/0:attn/ln"]["vc"].shape == (32,)
    assert f["blocks/0:attn/wq"]["vr"].shape == (2, 64)
    assert f["blocks/0:attn/wq"]["vc"].shape == (2, 32)
    assert set(f["final_norm"]) == {"v"}


def _state_leaves(state, at=""):
    """An optimiser state's tensors by ``"/"``-joined path (no step)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{at}{k}/"))
        elif k != "step":
            out[f"{at}{k}"] = v
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_in_place_updates_equal_the_functional_one(name):
    """``update_leaf`` in place, a slice at a time where the optimiser is
    elementwise (as the train step runs AdamW and SGD on a stacked leaf's
    periods), gives ``update``'s parameters and state bit for bit, and
    ``update`` leaves its inputs as they were."""
    opt = O.get(name, 1e-2)
    params = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    before = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    grads = {k: torch.from_numpy(v) for k, v in _tree(1).items()}
    want_p, want_st = opt.update(grads, state, params)
    for k, v in params.items():
        assert torch.equal(v, before[k]), k
    assert not any(t.any() for t in _state_leaves(state).values())
    for k, p in params.items():
        slots = {s: state[s][k] for s in state if s != "step"}
        if opt.elementwise and p.dim() > 1:
            for i in range(p.shape[0]):
                opt.update_leaf(grads[k][i], {s: v[i] for s, v in
                                              slots.items()}, p[i], 1)
        else:
            opt.update_leaf(grads[k], slots, p, 1)
    for k in params:
        assert torch.equal(params[k], want_p[k]), k
    got, want = _state_leaves(state), _state_leaves(want_st)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert opt.elementwise == (name != "adafactor")


def test_get_maps_the_three_names():
    for name in ("adamw", "adafactor", "sgd"):
        assert O.get(name, 0.1).name == name
    with pytest.raises(KeyError):
        O.get("lion", 0.1)


def test_compression_is_bit_exact_with_jax():
    """Three steps of error feedback on the same arrays: q, scale and the
    residual equal JAX's bit for bit, with half-way values (rounded to
    even) and an all-zero leaf (scale 1) among them."""
    grads = _tree(5)
    grads["ties"] = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5],
                             np.float32)
    grads["zero"] = np.zeros(4, np.float32)
    jres = jC.init_residual(grads)
    res = C.init_residual({k: torch.from_numpy(v) for k, v in grads.items()})
    for step in range(3):
        g = {k: v * (step + 1) for k, v in grads.items()}
        jc, jres = jC.compress(g, jres)
        c, res = C.compress({k: torch.from_numpy(v) for k, v in g.items()},
                            res)
        for k in g:
            np.testing.assert_array_equal(c.q[k].numpy(), np.asarray(jc.q[k]))
            assert c.q[k].dtype == torch.int8
            assert float(c.scale[k]) == float(jc.scale[k])
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k]))
        for k, v in jC.decompress(jc).items():
            np.testing.assert_array_equal(C.decompress(c)[k].numpy(),
                                          np.asarray(v))
        assert C.wire_bytes(c) == jC.wire_bytes(jc)
    first = C.compress({"ties": torch.from_numpy(grads["ties"])},
                       {"ties": torch.zeros(6)})[0]
    assert first.q["ties"].tolist() == [127, 2, -4, 0, 0, 2]


# ------------------------------------------------------------ convert
@pytest.fixture(scope="module")
def pairs():
    """arch -> (JAX config, its LM, float32 params; the port's config and
    LM carried across), reduced."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_j = jregistry.reduced(jregistry.get_config(arch))
            cfg_t = registry.reduced(registry.get_config(arch))
            jlm = JLM(cfg_j)
            params = jax.device_get(jlm.init_params(jax.random.PRNGKey(1),
                                                    jnp.float32))
            cache[arch] = (cfg_j, jlm, params, cfg_t,
                           lm_from_jax(cfg_t, params, device="cpu"))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-tiny",
                                  "jamba-1.5-large-398b"])
def test_lm_to_jax_inverts_lm_from_jax(arch, pairs):
    _, _, params, cfg, lm = pairs(arch)
    back = lm_to_jax(lm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(params)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    # leaf_groups walks JAX's flatten order, each group JAX's leaf
    paths = ["/".join(str(k.key) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [g.path for g in leaf_groups(lm)] == paths


def test_stacked_leaves_hold_the_parameters():
    """Each stacked leaf is the storage of its periods' parameters: a write
    into the leaf is a write into them, and ``leaf_groups`` hands over the
    leaf itself, not a copy."""
    cfg = registry.reduced(registry.get_config("whisper-tiny"))
    lm = LM(cfg, dtype=torch.float32, device="cpu")
    lm.init_params(torch.Generator("cpu").manual_seed(0))
    groups = leaf_groups(lm)
    assert {g.path for g in groups if g.stacked} == set(lm.stacked)
    assert any(p.startswith("enc_blocks/") for p in lm.stacked)
    for g in groups:
        if not g.stacked:
            assert g.leaf is lm.top[g.path] and g.tensors == [g.leaf]
            continue
        assert g.leaf is lm.stacked[g.path]
        assert g.leaf.shape[0] == len(g.tensors)
        with torch.no_grad():
            g.leaf.add_(1.0)
        for n, t in enumerate(g.tensors):
            assert t.data_ptr() == g.leaf[n].data_ptr()
            assert torch.equal(t, g.leaf[n])
    n_params = sum(t.numel() for t in lm.parameters())
    assert n_params == sum(g.leaf.numel() for g in groups)
    decoder_only = LM(registry.reduced(registry.get_config("yi-6b")),
                      dtype=torch.float32, device="cpu")
    assert not any(p.startswith("enc_blocks/") for p in decoder_only.stacked)


def test_lm_to_jax_carries_bfloat16_bits():
    cfg_j = jregistry.reduced(jregistry.get_config("qwen3-moe-235b-a22b"))
    params = jax.device_get(JLM(cfg_j).init_params(jax.random.PRNGKey(2),
                                                   jnp.bfloat16))
    lm = lm_from_jax(registry.reduced(registry.get_config(
        "qwen3-moe-235b-a22b")), params, device="cpu")
    for a, b in zip(jax.tree.leaves(lm_to_jax(lm)), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------ loss and gradients
def _batch(cfg, B=2, S=24, seed=4):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -100                     # masked, as padding would be
    batch = {"tokens": toks, "labels": labels}
    if cfg.enc_layers:
        batch["enc_frames"] = rng.randn(B, cfg.cross_len, cfg.d_model).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_leaf_equal_jax(arch, pairs):
    """``LM.loss`` within 1e-5 and every gradient leaf within 1e-4 of
    ``jax.value_and_grad(lm.loss)`` (qwen3-moe through its aux term,
    whisper-tiny through its encoder on ``enc_frames``)."""
    cfg_j, jlm, params, cfg, lm = pairs(arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(jlm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    groups = leaf_groups(lm)
    for g in groups:
        for t in g.tensors:
            t.requires_grad_(True)
    try:
        loss, metrics = lm.loss({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        loss.backward()
        got = {g.path: g.stack([t.grad for t in g.tensors]).numpy()
               for g in groups}
    finally:
        for g in groups:
            for t in g.tensors:
                t.requires_grad_(False)
                t.grad = None
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_TOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jm[k]), rtol=LOSS_TOL, atol=1e-7,
                                   err_msg=k)
    if cfg.n_experts:
        assert float(metrics["aux"].detach()) > 0
    want = _flat(jg)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{arch} {k}")


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_gradient(arch, policy, pairs):
    """Rematerialised periods (``cfg.remat``) give the same loss and
    gradients as plain ones, bit for bit on the CPU."""
    *_, cfg, lm = pairs(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    for remat in (False, True):
        lm.cfg = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        params = list(lm.parameters())
        for t in params:
            t.requires_grad_(True)
        try:
            loss, _ = lm.loss(batch)
            loss.backward()
            out[remat] = [loss.detach()] + [t.grad.clone() for t in params]
        finally:
            for t in params:
                t.requires_grad_(False)
                t.grad = None
    lm.cfg = cfg
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def test_serving_builds_no_graph(pairs):
    *_, cfg, lm = pairs("yi-6b")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    for t in lm.parameters():
        t.requires_grad_(True)
    try:
        logits = lm_step.make_prefill_step(lm)(toks)
        _, cache = lm.prefill(toks[:, :4], s_max=8)
    finally:
        for t in lm.parameters():
            t.requires_grad_(False)
    assert not logits.requires_grad and logits.grad_fn is None
    assert all(not t.requires_grad for t in cache["blocks"]["0:attn"].values())


# ------------------------------------------------------------- train step
STEP_RUNS = [("adamw", 1, False), ("adamw", 2, False),
             ("adafactor", 1, False), ("adafactor", 2, True),
             ("sgd", 1, False), ("sgd", 2, True)]


@pytest.mark.parametrize("name,grad_accum,compress", STEP_RUNS)
def test_train_step_equals_jax(name, grad_accum, compress, pairs):
    """Two steps of ``make_train_step`` against JAX's jitted step from the
    same parameters and batches. Compression is held with SGD and
    Adafactor: AdamW's first step turns each gradient into its sign, so a
    last-bit difference that moves one int8 code across zero would move a
    parameter by the whole learning rate."""
    cfg_j, jlm, params, cfg, _ = pairs("yi-6b")
    jopt, opt = jO.get(name, 3e-4), O.get(name, 3e-4)
    jfn = jax.jit(jstep.make_train_step(jlm, jopt, grad_accum=grad_accum,
                                        compress_grads=compress))
    jst = jstep.make_opt_state(params, jopt, compress)
    lm = lm_from_jax(cfg, params, device="cpu")
    fn = lm_step.make_train_step(lm, opt, grad_accum=grad_accum,
                                 compress_grads=compress)
    st = lm_step.make_opt_state(lm, opt, compress)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=4))
    jp = params
    for i in range(2):
        b = pipe.global_batch_at(i)
        jp, jst, jm = jfn(jp, jst, jax.tree.map(jnp.asarray, b))
        st, m = fn(st, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(m) == set(jm)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_TOL, err_msg=f"step {i} {k}")
    for path, a in _flat(lm_to_jax(lm)).items():
        np.testing.assert_allclose(a, _flat(jp)[path], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=path)
    inner, jinner = (st["opt"], jst["opt"]) if compress else (st, jst)
    assert inner["step"] == int(jinner["step"]) == 2
    assert not any(t.requires_grad or t.grad is not None
                   for t in lm.parameters())
    if compress:
        for path, r in st["residual"].items():
            np.testing.assert_allclose(
                r.numpy(), _flat(jst["residual"])[path], rtol=PARAM_TOL,
                atol=PARAM_TOL, err_msg=path)


def test_token_pipeline_feeds_jax_s_batches():
    kw = dict(vocab=256, seq_len=16, global_batch=4)
    for i in range(3):
        a = TokenPipeline(TokenPipelineConfig(**kw)).global_batch_at(i)
        b = JPipeline(JPipelineConfig(**kw)).global_batch_at(i)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- asset
def test_lm_train_asset_is_jax_s_and_the_port_reproduces_it():
    """``lm_train_expected.npz`` is JAX's training on its recipe; the
    port's model redrawn as ``chip_smoke.py`` redraws it equals the
    exporter's tree carried across, and its three runs give the asset's
    losses and gradient norms within 1e-5 and parameters within 1e-4 (the
    check chip_smoke.py phase 6d makes on the card)."""
    with np.load(ASSET) as z:
        want = {name: z[name] for name in z.files}
    meta = json.loads(str(want["meta"]))
    assert meta == json.loads(json.dumps(SCRIPT.LM_TRAIN_CASE))
    cfg_j = jregistry.reduced(jregistry.get_config(meta["arch"]))
    tree = SCRIPT.draw_lm_train_case(meta, SCRIPT.whisper_shapes(cfg_j))
    cfg = registry.reduced(registry.get_config(meta["arch"]))
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=meta["seq"], global_batch=meta["batch"]))
    for run, (name, grad_accum, compress) in meta["runs"].items():
        lm = LM(cfg, dtype=torch.float32, device="cpu")
        SMOKE.draw_lm_train(lm, meta)
        for a, b in zip(jax.tree.leaves(lm_to_jax(lm)),
                        jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
        opt = O.get(name, meta["lr"])
        fn = lm_step.make_train_step(lm, opt, grad_accum=grad_accum,
                                     compress_grads=compress)
        st = lm_step.make_opt_state(lm, opt, compress)
        for i in range(meta["steps"]):
            st, m = fn(st, {k: torch.from_numpy(v) for k, v in
                            pipe.global_batch_at(i).items()})
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(m[k]), want[f"{run}_{k}"][i],
                                           rtol=LOSS_TOL, err_msg=run)
        for path, a in _flat(lm_to_jax(lm)).items():
            np.testing.assert_allclose(a, want[f"{run}/{path}"],
                                       rtol=PARAM_TOL, atol=PARAM_TOL,
                                       err_msg=f"{run} {path}")


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::flash_tf32_kernel<float, 128>(Params)",
     "attention forward"),
    ("void (anonymous namespace)::flash_sm90_kernel<128>(CUtensorMap_st)",
     "attention forward"),
    ("void (anonymous namespace)::flash_bwd_dq_tf32_kernel<float, 128>"
     "((anonymous namespace)::Params)", "attention backward"),
    ("void (anonymous namespace)::flash_bwd_dkdv_simt_kernel<float, 32>"
     "((anonymous namespace)::Params)", "attention backward"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8", "forward "
     "products")])
def test_the_profile_groups_name_each_attention_kernel(kernel, group):
    """``chip_smoke.py``'s training profile puts each flash kernel, by the
    name its source gives it, in the attention's groups."""
    assert SMOKE.train_group(kernel, []).startswith(group)
    if group == "attention forward":
        assert SMOKE.family_group(kernel, []).startswith("attention")
        assert SMOKE.frontend_group(kernel, ["encode"]).startswith(
            "attention")
        assert SMOKE.group_of(kernel).startswith("flash_attention")


# -------------------------------------------------------------- launcher
def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)["arrays"]


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch yi-6b --reduced --steps
    10 --ckpt <tmp> --device cpu``: stopped after 5 steps and resumed to 10,
    it ends where a run of 10 steps ends, bit for bit (the checkpoints'
    manifests, digests included, are equal)."""
    base = ["--arch", "yi-6b", "--reduced", "--batch", "4", "--seq", "16",
            "--ckpt-every", "5", "--device", "cpu"]
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
    launcher.main(base + ["--steps", "5", "--ckpt", cut])
    m = launcher.main(base + ["--steps", "10", "--ckpt", cut])
    out = capsys.readouterr().out
    assert "[resume] restored step 5" in out
    assert out.count("training complete.") == 2
    assert "step    6  loss" in out and "step   10  loss" in out
    w = launcher.main(base + ["--steps", "10", "--ckpt", whole])
    assert float(m["loss"]) == float(w["loss"])
    assert _manifest(cut, 10) == _manifest(whole, 10)
    assert CheckpointManager(cut).all_steps() == [5, 10]
    # a run that already reached its steps restores and trains no more
    assert launcher.main(base + ["--steps", "10", "--ckpt", whole]) is None


def test_launcher_feeds_an_encoder_decoder_frames(tmp_path, capsys):
    m = launcher.main(["--arch", "whisper-tiny", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--device", "cpu",
                       "--grad-accum", "2", "--compress-grads"])
    assert set(m) == {"loss", "grad_norm", "ce"}
    assert np.isfinite(float(m["loss"]))
    assert "training complete." in capsys.readouterr().out


def test_launcher_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])
