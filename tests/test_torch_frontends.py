"""The port's audio encoder-decoder (Whisper) and vision-prefix (InternVL)
families against the JAX package on the CPU, at reduced size, parameters
carried across by ``lm_from_jax`` and the frontend stubs drawn with numpy
from a seed: the sinusoid table, the encoder, the forward with
``enc_frames`` or ``patch_embeds``, decode and prefill with the cross
cache, the step factories, ``ServeEngine`` and the launcher. The committed
``src/repro_torch/assets/whisper_expected.npz`` (JAX's float32
whisper-tiny at full width, which ``chip_smoke.py`` holds the card to) is
held to the port's plain path here.

Tolerances: the encoder's output within 1e-5 of JAX's, logits within
``LOGIT_TOL`` (1e-4), cache entries within 1e-5, the port's decode against
its forward within ``DECODE_TOL`` (2e-3), served tokens equal."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_families as fam
from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.serving.engine import ServeEngine as JServeEngine
from repro.training import lm_step as jlm_step
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import lm_step

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSET = os.path.join(ROOT, "src", "repro_torch", "assets",
                     "whisper_expected.npz")
ARCHS = ("whisper-tiny", "internvl2-26b")
ENC_TOL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _load("export_torch_fixture",
               os.path.join(ROOT, "scripts", "export_torch_fixture.py"))
SMOKE = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = fam.pair(*fam.configs(arch), seed=1)
        return cache[arch]
    return get


def _t(stub):
    return {k: torch.from_numpy(v) for k, v in stub.items()}


def _j(stub):
    return {k: jnp.asarray(v) for k, v in stub.items()}


# ------------------------------------------------------------------ sinusoid
@pytest.mark.parametrize("S,d", [(1500, 384), (24, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid_equals_jax_bit_for_bit(S, d, dtype):
    got = model._sinusoid(S, d, getattr(torch, dtype), torch.device("cpu"))
    want = np.asarray(jmodel._sinusoid(S, d, getattr(jnp, dtype)))
    assert got.shape == want.shape == (1, S, d)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_a_float32_sinusoid_is_not_jax_s():
    """The trap the float64 table avoids: the same formula in float32 in
    torch moves the table by more than 1e-5 at Whisper's S 1500, d 384, and
    changes bf16 values."""
    S, d = 1500, 384
    pos = torch.arange(S, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    f32 = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]
    want = np.asarray(jmodel._sinusoid(S, d, jnp.float32))
    assert float(np.abs(f32.numpy() - want).max()) > 1e-5
    want16 = np.asarray(jmodel._sinusoid(S, d, jnp.bfloat16), np.float32)
    assert int((f32.bfloat16().float().numpy() != want16).sum()) > 100


# ---------------------------------------------------------------- parameters
def test_leaves_and_init_draws_like_jax(models):
    """The cross-attention leaves sit in every decoder sublayer under JAX's
    names, the encoder's layers hold no cross leaves and one K/V head per
    query head; ``init_params`` draws them by JAX's rules."""
    jlm, params, lm = models("whisper-tiny")
    cross = {"x_ln", "x_ln_b", "x_wq", "x_wk", "x_wv", "x_wo"}
    for blk in lm.layers:
        assert cross <= set(blk["0:attn"])
    assert set(lm.encoder[0]["0:attn"]) == set(params["enc_blocks"]["0:attn"])
    assert not cross & set(lm.encoder[0]["0:attn"])
    assert len(lm.encoder) == lm.cfg.enc_layers == 2
    assert {"enc_final_norm", "enc_final_norm_b"} <= set(lm.top)
    built = LM(lm.cfg, device="cpu").init_params(
        torch.Generator().manual_seed(7))
    assert built.dtype == torch.bfloat16
    sub = built.layers[1]["0:attn"]
    assert abs(float(sub["x_wk"].float().std()) - 0.02) < 0.002
    assert torch.equal(sub["x_ln"], torch.ones_like(sub["x_ln"]))
    assert not sub["x_ln_b"].any()
    enc = built.encoder[1]["0:attn"]
    assert enc["wk"].shape == (64, 64)
    assert abs(float(enc["w_in"].float().std()) - 0.02) < 0.002
    assert torch.equal(built.top["enc_final_norm"],
                       torch.ones_like(built.top["enc_final_norm"]))
    assert not built.top["enc_final_norm_b"].any()


def test_converter_refuses_a_wrong_encoder_tree(models):
    """A missing, extra, misshapen or differently typed leaf of the
    encoder, and a tree without ``enc_blocks``, are refused."""
    _, params, lm = models("whisper-tiny")
    tree = jax.tree.map(np.asarray, params)
    cfg = lm.cfg

    def edited(fn):
        t = jax.tree.map(lambda a: a, tree)
        t["enc_blocks"] = {"0:attn": dict(tree["enc_blocks"]["0:attn"])}
        fn(t)
        return t

    enc = lambda t: t["enc_blocks"]["0:attn"]        # noqa: E731
    with pytest.raises(ValueError, match="enc_blocks"):
        lm_from_jax(cfg, {k: v for k, v in tree.items()
                          if k != "enc_blocks"}, device="cpu")
    with pytest.raises(ValueError, match="the JAX tree"):
        lm_from_jax(cfg, edited(lambda t: enc(t).pop("w_in")), device="cpu")
    with pytest.raises(ValueError, match="the JAX tree"):
        lm_from_jax(cfg, edited(lambda t: enc(t).update(
            x_wq=enc(t)["wq"])), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        lm_from_jax(cfg, edited(lambda t: enc(t).update(
            wq=enc(t)["wq"][:, :, :8])), device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        lm_from_jax(cfg, edited(lambda t: enc(t).update(
            wq=enc(t)["wq"].astype(jnp.bfloat16))), device="cpu")
    with pytest.raises(ValueError, match="the JAX tree"):
        lm_from_jax(cfg, {k: v for k, v in tree.items()
                          if k != "enc_final_norm_b"}, device="cpu")


# ------------------------------------------------------------ the encoder
def test_encode_matches_jax(models):
    jlm, params, lm = models("whisper-tiny")
    frames = fam.frontend(lm.cfg)["enc_frames"]
    want = np.asarray(jlm.encode(params, jnp.asarray(frames)))
    fa_ops.reset_launches()
    got = lm.encode(torch.from_numpy(frames))
    assert got.shape == frames.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=ENC_TOL, atol=ENC_TOL)
    assert fa_ops.LAUNCHES == {"flash_attention": 0,
                               "flash_attention_sm90": 0,
                               "flash_attention_bwd": 0}


def test_frames_of_another_dtype_are_refused(models):
    """JAX promotes float32 frames in a bf16 model; the port refuses them,
    naming both dtypes, and never casts."""
    _, _, lm = models("whisper-tiny")
    frames = torch.from_numpy(fam.frontend(lm.cfg)["enc_frames"])
    for bad in (frames.bfloat16(), frames.double()):
        with pytest.raises(ValueError, match=f"{bad.dtype}.*float32"):
            lm.encode(bad)
        with pytest.raises(ValueError, match="enc_frames"):
            lm.forward(torch.zeros((2, 4), dtype=torch.int32),
                       enc_frames=bad)


# ---------------------------------------------------------------- the forward
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_its_frontend_matches_jax(arch, models):
    fam.check_forward(*models(arch))


def test_patches_are_spliced_over_the_first_positions(models):
    """The patch embeddings replace the first P token embeddings (cast to
    the model's dtype; the sequence keeps its length), so the tokens under
    them change no logit, in the port as in JAX."""
    jlm, params, lm = models("internvl2-26b")
    P = lm.cfg.n_patches
    patches = fam.frontend(lm.cfg)["patch_embeds"]
    toks = fam.tokens(lm.cfg.vocab)
    other = toks.copy()
    other[:, :P] = (other[:, :P] + 7) % lm.cfg.vocab
    x = lm._embed(torch.from_numpy(toks), torch.from_numpy(patches).double())
    assert x.shape == (2, 24, lm.cfg.d_model) and x.dtype == torch.float32
    np.testing.assert_array_equal(x[:, :P].numpy(), patches)
    np.testing.assert_array_equal(
        x[:, P:].numpy(), lm.top["embed"][torch.from_numpy(toks[:, P:]).long()]
        .numpy())
    a, _ = lm.forward(torch.from_numpy(toks),
                      patch_embeds=torch.from_numpy(patches))
    b, _ = lm.forward(torch.from_numpy(other),
                      patch_embeds=torch.from_numpy(patches))
    assert torch.equal(a, b)
    c, _ = lm.forward(torch.from_numpy(other))
    assert not torch.equal(a, c)
    ja, _ = jlm.forward(params, jnp.asarray(toks),
                        patch_embeds=jnp.asarray(patches))
    jb, _ = jlm.forward(params, jnp.asarray(other),
                        patch_embeds=jnp.asarray(patches))
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_passes_the_frontend(arch, models):
    jlm, params, lm = models(arch)
    toks = fam.tokens(lm.cfg.vocab, seed=5)
    stub = fam.frontend(lm.cfg, seed=7)
    got = lm_step.make_prefill_step(lm)(torch.from_numpy(toks), **_t(stub))
    assert torch.equal(got, lm.forward(torch.from_numpy(toks),
                                       **_t(stub))[0])
    want = jlm_step.make_prefill_step(jlm)(params, jnp.asarray(toks),
                                           **_j(stub))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=fam.LOGIT_TOL, atol=fam.LOGIT_TOL)


# --------------------------------------------------------- decode and prefill
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_prefill_match_jax(arch, models):
    """Token by token against JAX's, every cache entry within 1e-5; an
    encoder-decoder's cross cache (enc_len 24) stays JAX's zeros."""
    jlm, params, lm = models(arch)
    kw = {"enc_len": 24} if lm.cfg.enc_layers else {}
    fam.check_prefill(jlm, params, lm, **kw)


def test_cross_cache_layout_matches_jax(models):
    jlm, params, lm = models("whisper-tiny")
    for enc_len in (None, 40):
        want = jlm.init_cache(3, 16, dtype=jnp.bfloat16, enc_len=enc_len)
        got = LM(lm.cfg, device="cpu").init_cache(3, 16, enc_len=enc_len)
        for name in ("k", "v", "xk", "xv"):
            w = want["blocks"]["0:attn"][name]
            t = got["blocks"]["0:attn"][name]
            assert tuple(t.shape) == w.shape and t.dtype == torch.bfloat16
            assert not t.any()
    assert got["blocks"]["0:attn"]["xk"].shape[3] == 40


def _fill_cross(lm, cache, enc):
    """The port's cross cache filled from the encoder's output through the
    forward's own projection (``LM._cross_kv``)."""
    for n, i, kind, p in lm.sublayers():
        k, v = lm._cross_kv(enc, p)
        cache["blocks"][f"{i}:{kind}"]["xk"][n] = k
        cache["blocks"][f"{i}:{kind}"]["xv"][n] = v
    return cache


def _jax_fill_cross(jlm, params, cache, enc):
    """The same in JAX: each layer's x_wk, x_wv projection of ``enc``, as
    JAX's ``_cross_attn`` computes it without a cache."""
    c = jlm.cfg
    B = enc.shape[0]
    sub = params["blocks"]["0:attn"]
    ks, vs = [], []
    for n in range(c.n_periods):
        k = (enc @ sub["x_wk"][n]).reshape(B, -1, c.n_kv_heads, c.d_head)
        v = (enc @ sub["x_wv"][n]).reshape(B, -1, c.n_kv_heads, c.d_head)
        ks.append(jnp.moveaxis(k, 1, 2))
        vs.append(jnp.moveaxis(v, 1, 2))
    entry = dict(cache["blocks"]["0:attn"], xk=jnp.stack(ks),
                 xv=jnp.stack(vs))
    return {"blocks": {"0:attn": entry}, "len": cache["len"]}


def test_decode_matches_forward_with_the_cross_cache_filled(models):
    """With the cross cache filled from ``encode``, token-by-token decode
    gives the forward's last logits within DECODE_TOL, in the port and,
    by the same procedure, in JAX."""
    jlm, params, lm = models("whisper-tiny")
    toks = fam.tokens(lm.cfg.vocab, seed=3)
    frames = fam.frontend(lm.cfg, seed=8)["enc_frames"]
    ft = torch.from_numpy(frames)
    full, _ = lm.forward(torch.from_numpy(toks), enc_frames=ft)
    cache = _fill_cross(lm, lm.init_cache(2, 32, enc_len=frames.shape[1]),
                        lm.encode(ft))
    xk = cache["blocks"]["0:attn"]["xk"].clone()
    for t in range(toks.shape[1]):
        last, cache = lm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
    assert torch.equal(cache["blocks"]["0:attn"]["xk"], xk)
    assert float((full[:, -1] - last[:, 0]).abs().max()) < fam.DECODE_TOL
    # the same procedure in JAX
    jfull, _ = jlm.forward(params, jnp.asarray(toks),
                           enc_frames=jnp.asarray(frames))
    jcache = _jax_fill_cross(jlm, params,
                             jlm.init_cache(2, 32, dtype=jnp.float32,
                                            enc_len=frames.shape[1]),
                             jlm.encode(params, jnp.asarray(frames)))
    np.testing.assert_allclose(cache["blocks"]["0:attn"]["xv"].numpy(),
                               np.asarray(jcache["blocks"]["0:attn"]["xv"]),
                               rtol=1e-5, atol=1e-5)
    step = jax.jit(jlm.decode_step)
    for t in range(toks.shape[1]):
        jlast, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
    assert float(np.abs(np.asarray(jfull)[:, -1]
                        - np.asarray(jlast)[:, 0]).max()) < fam.DECODE_TOL
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               rtol=fam.LOGIT_TOL, atol=fam.LOGIT_TOL)


# ------------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_jax(arch, models):
    """Text prompts only, Whisper against the zero cross cache, as JAX's
    engine serves them: the same tokens."""
    fam.check_serve_engine(*models(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_jax_s_tokens(arch, monkeypatch, capsys):
    """The port's launcher on JAX's launcher's weights (its float32
    ``init_params(PRNGKey(0))``, carried across) serves the tokens JAX's
    launcher serves."""
    served = {}

    def recorder(cls, key):
        real = cls.generate

        def generate(self, prompts, max_new=16):
            served[key] = real(self, prompts, max_new)
            return served[key]
        monkeypatch.setattr(cls, "generate", generate)

    recorder(JServeEngine, "jax")
    recorder(ServeEngine, "port")
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    cfg_j = jregistry.reduced(jregistry.get_config(arch))
    carried = lm_from_jax(
        registry.reduced(registry.get_config(arch)),
        jax.tree.map(np.asarray, jmodel.LM(cfg_j).init_params(
            jax.random.PRNGKey(0), jnp.float32)), device="cpu")

    def init_params(self, generator):
        self.load_state_dict(carried.state_dict())
        return self
    monkeypatch.setattr(LM, "init_params", init_params)
    st = serve.main(argv + ["--device", "cpu"])
    assert st["tokens_out"] == 6
    assert "served 3 requests on cpu" in capsys.readouterr().out
    assert served["port"] == served["jax"]
    assert len(served["port"]) == 3


# ------------------------------------------------------- the committed asset
def test_whisper_asset_is_jax_s_and_the_port_s_at_full_width():
    """``whisper_expected.npz`` is JAX's float32 whisper-tiny on its recipe,
    the port's model redrawn from the recipe as ``chip_smoke.py`` redraws it
    equals the exporter's tree carried across, and the port's plain path
    gives the asset's encoder rows and logits within LOGIT_TOL."""
    with np.load(ASSET) as z:
        want = {name: z[name] for name in z.files}
    meta = json.loads(str(want["meta"]))
    assert meta == SCRIPT.WHISPER_CASE
    fresh = SCRIPT.whisper_expected()
    for name in ("enc_out", "logits"):
        np.testing.assert_allclose(fresh[name], want[name], rtol=ENC_TOL,
                                   atol=ENC_TOL)
    cfg = registry.get_config(meta["arch"])
    frames, toks, tree = SCRIPT.draw_whisper_case(
        meta, SCRIPT.whisper_shapes(jregistry.get_config(meta["arch"])))
    lm = LM(cfg, dtype=torch.float32, device="cpu")
    frames_c, toks_c = SMOKE.draw_whisper(lm, meta)
    np.testing.assert_array_equal(frames_c, frames)
    np.testing.assert_array_equal(toks_c, toks)
    carried = lm_from_jax(cfg, tree, device="cpu")
    for (name, a), b in zip(lm.named_parameters(), carried.parameters()):
        assert torch.equal(a, b), name
    del carried, tree
    ft = torch.from_numpy(frames)
    enc = lm.encode(ft)
    logits, _ = lm.forward(torch.from_numpy(toks), enc_frames=ft)
    np.testing.assert_allclose(enc[:, meta["enc_rows"]].numpy(),
                               want["enc_out"], rtol=fam.LOGIT_TOL,
                               atol=fam.LOGIT_TOL)
    got = logits[:, meta["logit_positions"]].numpy()
    assert got.shape == want["logits"].shape == (1, 4, cfg.vocab)
    np.testing.assert_allclose(got, want["logits"], rtol=fam.LOGIT_TOL,
                               atol=fam.LOGIT_TOL)
