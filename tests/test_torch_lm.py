"""The LM zoo's serving path of the port against the JAX package on the CPU,
at reduced size: configurations and the registry, the layers, ``LM``
(parameters carried across from JAX's ``init_params`` by ``convert``), the
forward, decode and prefill with their KV cache, the step factories, the
token pipeline, ``ServeEngine`` and the launcher.

Tolerances: logits within 1e-4 of JAX's (float32; the two frameworks sum
in different orders), the port's own decode against its forward within
2e-3 (``tests/test_models.py``'s bound), greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry, shapes as jshapes
from repro.data.tokens import TokenPipeline as JPipeline
from repro.data.tokens import TokenPipelineConfig as JPipelineConfig
from repro.models import layers as jlayers
from repro.serving.engine import ServeEngine as JServeEngine
from repro.training import lm_step as jlm_step
from repro_torch.configs import registry, shapes
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import lm_step

from _torch_lm_families import (LOGIT_TOL, jax_prefill, pair, prompts,
                                tokens)

DENSE = ("qwen3-8b", "yi-6b", "qwen2.5-32b", "mistral-nemo-12b")


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = pair(jregistry.reduced(jregistry.get_config(arch)),
                                registry.reduced(registry.get_config(arch)),
                                seed=1)
        return cache[arch]
    return get


# ------------------------------------------------------------ configurations
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_configs_equal_jax(arch):
    full_j, full_t = jregistry.get_config(arch), registry.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(registry.reduced(full_t)) == \
        dataclasses.asdict(jregistry.reduced(full_j))
    for c_t, c_j in ((full_t, full_j), (registry.reduced(full_t),
                                        jregistry.reduced(full_j))):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
        assert c_t.period == c_j.period and c_t.n_periods == c_j.n_periods


def test_registry_aliases_and_shapes_equal_jax():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.ALIASES == jregistry.ALIASES
    for alias, mod in registry.ALIASES.items():
        assert registry.get_config(alias) == registry.get_config(mod)
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in registry.ARCH_IDS:
        for cell in shapes.SHAPES:
            assert shapes.applicable(registry.get_config(arch), cell) == \
                jshapes.applicable(jregistry.get_config(arch), cell)


def test_qwen3_8b_size():
    cfg = registry.get_config("qwen3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab) == (36, 4096, 32, 8, 128, 12288,
                                                  151936)
    assert cfg.param_count() == 8_190_427_136


@pytest.mark.parametrize("arch", DENSE + ("mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "mamba2-780m", "jamba-1.5-large-398b",
                                  "whisper-tiny", "internvl2-26b"))
def test_module_parameter_count(arch, models):
    """The module holds exactly JAX's parameters: its matrices other than
    the routers and its 3-D expert tensors are what ``param_count()``
    counts (Whisper's encoder and cross-attention among them), and the
    routers, norms, biases and SSM vectors, which that count leaves out,
    make up the rest of JAX's tree."""
    jlm, params, lm = models(arch)
    cfg = lm.cfg
    counted = sum(p.numel() for name, p in lm.named_parameters()
                  if p.dim() == 3
                  or (p.dim() == 2 and not name.endswith(".router")))
    assert counted == cfg.param_count()
    jax_total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in lm.parameters()) == jax_total


# -------------------------------------------------------------------- layers
def test_layers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None, :] + 7
    t = torch.from_numpy
    pairs = [
        (layers.rmsnorm(t(x), t(scale)), jlayers.rmsnorm(x, scale)),
        (layers.layernorm(t(x), t(scale), t(bias)),
         jlayers.layernorm(x, scale, bias)),
        (layers.apply_rope(t(x), t(pos), 1e6),
         jlayers.apply_rope(x, pos, 1e6)),
        (layers.rope_freqs(16, 5e6, "cpu"), jlayers.rope_freqs(16, 5e6)),
    ]
    w1, w2 = rng.randn(16, 32).astype(np.float32), rng.randn(16, 32).astype(
        np.float32)
    w3, b1 = rng.randn(32, 16).astype(np.float32), rng.randn(32).astype(
        np.float32)
    pairs.append((layers.swiglu(t(x), t(w1), t(w2), t(w3)),
                  jlayers.swiglu(x, w1, w2, w3)))
    pairs.append((layers.gelu_mlp(t(x), t(w1), t(b1), t(w3), t(bias)),
                  jlayers.gelu_mlp(x, w1, b1, w3, bias)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_rmsnorm_casts_before_the_scale_in_bfloat16():
    """Normalise in float32, cast to bf16, then scale (bf16 * bf16): the
    port rounds where JAX rounds, so bf16 results agree bit for bit."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 64).astype(np.float32)
    scale = (1 + rng.randn(64) * 0.1).astype(np.float32)
    got = layers.rmsnorm(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(scale).bfloat16())
    want = jlayers.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(scale, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("window,rotated", [(None, False), (4, False),
                                            (6, True)])
def test_decode_attention_matches_jax(window, rotated):
    rng = np.random.RandomState(4)
    q = rng.randn(2, 8, 1, 16).astype(np.float32)
    kc = rng.randn(2, 2, 6, 16).astype(np.float32)
    vc = rng.randn(2, 2, 6, 16).astype(np.float32)
    t = torch.from_numpy
    got = layers.decode_attention(t(q), t(kc), t(vc), cache_len=5,
                                  window=window, window_rotated=rotated)
    want = jlayers.decode_attention(q, kc, vc, cache_len=jnp.int32(5),
                                    window=window, window_rotated=rotated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ["qwen3-8b", "yi-6b", "qwen2.5-32b"])
def test_forward_matches_jax(arch, models):
    jlm, params, lm = models(arch)
    toks = tokens(lm.cfg.vocab)
    want, aux_j = jlm.forward(params, jnp.asarray(toks))
    fa_ops.reset_launches()
    got, aux = lm.forward(torch.from_numpy(toks))
    assert got.shape == (2, 24, lm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert float(aux) == float(aux_j) == 0.0
    # the CPU launches neither kernel, whichever route a card would take
    assert fa_ops.LAUNCHES == {"flash_attention": 0,
                               "flash_attention_sm90": 0,
                               "flash_attention_bwd": 0}


@pytest.mark.parametrize("arch", ["qwen3-8b", "yi-6b", "qwen2.5-32b"])
def test_decode_and_prefill_match_jax(arch, models):
    jlm, params, lm = models(arch)
    toks = tokens(lm.cfg.vocab)
    want, jcache = jax_prefill(jlm, params, toks, s_max=32)
    got, cache = lm.prefill(torch.from_numpy(toks), s_max=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert cache["len"] == int(jcache["len"]) == 24
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache["blocks"]["0:attn"][name].numpy(),
            np.asarray(jcache["blocks"]["0:attn"][name]), rtol=1e-5,
            atol=1e-5)
    # one more step through the serve-step factories
    nxt = toks[:, :1]
    want1, _ = jlm_step.make_serve_step(jlm)(params, jcache, jnp.asarray(nxt))
    got1, cache = lm_step.make_serve_step(lm)(cache, torch.from_numpy(nxt))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert cache["len"] == 25


@pytest.mark.parametrize("arch", ["qwen3-8b", "yi-6b"])
def test_incremental_decode_matches_forward(arch, models):
    _, _, lm = models(arch)
    toks = torch.from_numpy(tokens(lm.cfg.vocab, seed=3))
    full, _ = lm.forward(toks)
    last, _ = lm.prefill(toks, s_max=32)
    assert float((full[:, -1] - last[:, 0]).abs().max()) < 2e-3


def test_windowed_dense_ring_cache_matches_jax():
    """A sliding window of 8 over 24 tokens: the forward masks by the
    window, the decode cache is an 8-slot ring buffer."""
    base = "qwen3-8b"
    cfg_j = dataclasses.replace(jregistry.reduced(jregistry.get_config(base)),
                                attn_window=8)
    cfg_t = dataclasses.replace(registry.reduced(registry.get_config(base)),
                                attn_window=8)
    jlm, params, lm = pair(cfg_j, cfg_t, seed=3)
    toks = np.random.RandomState(4).randint(0, cfg_t.vocab, (1, 24)).astype(
        np.int32)
    want_full, _ = jlm.forward(params, jnp.asarray(toks))
    got_full, _ = lm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    want, jcache = jax_prefill(jlm, params, toks, s_max=64)
    got, cache = lm.prefill(torch.from_numpy(toks), s_max=64)
    assert cache["blocks"]["0:attn"]["k"].shape[3] == 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(cache["blocks"]["0:attn"]["k"].numpy(),
                               np.asarray(jcache["blocks"]["0:attn"]["k"]),
                               rtol=1e-5, atol=1e-5)
    assert float((got_full[:, -1] - got[:, 0]).abs().max()) < 2e-3


def test_prefill_step_equals_forward(models):
    jlm, params, lm = models("qwen3-8b")
    toks = tokens(lm.cfg.vocab, seed=5)
    got = lm_step.make_prefill_step(lm)(torch.from_numpy(toks))
    assert torch.equal(got, lm.forward(torch.from_numpy(toks))[0])
    want = jlm_step.make_prefill_step(jlm)(params, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_init_params_draws_like_jax():
    """Seeded draws on the model's device: the same seed gives the same
    model, matrices have JAX's scale, norms are one and biases zero."""
    cfg = registry.reduced(registry.get_config("qwen2.5-32b"))
    a = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(7))
    b = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(7))
    assert a.dtype == torch.bfloat16          # JAX's default dtype
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    wq = a.layers[0]["0:attn"]["wq"].float()
    assert abs(float(wq.std()) - 0.02) < 0.002
    ln = a.layers[1]["0:attn"]["ln"]
    assert torch.equal(ln, torch.ones_like(ln))
    assert not a.layers[0]["0:attn"]["bq"].any()


# ------------------------------------------------------------------- serving
@pytest.mark.parametrize("eos", [None, "first"])
def test_serve_engine_matches_jax(eos, models):
    jlm, params, lm = models("qwen3-8b")
    ps = prompts(lm.cfg.vocab, 4)
    if eos == "first":      # a token the greedy decode emits: rows stop early
        eos = JServeEngine(jlm, params, max_batch=3, s_max=64).generate(
            ps, max_new=6)[0][2]
    jeng = JServeEngine(jlm, params, max_batch=3, s_max=64, eos=eos)
    want = jeng.generate(ps, max_new=6)
    eng = ServeEngine(lm, max_batch=3, s_max=64, eos=eos, device="cpu")
    got = eng.generate(ps, max_new=6)
    assert got == want
    st, jst = eng.stats(), jeng.stats()
    assert set(st) == set(jst)
    assert st["tokens_out"] == jst["tokens_out"]
    assert st["system_s"] >= st["accelerator_s"] > 0.0


def test_serve_engine_refuses_a_model_on_another_device(models):
    _, _, lm = models("qwen3-8b")
    with pytest.raises(ValueError, match="lies on cpu"):
        ServeEngine(lm, device="meta")


def test_launcher_serves_on_the_cpu(capsys, monkeypatch):
    st = serve.main(["--arch", "yi-6b", "--reduced", "--requests", "3",
                     "--max-new", "2", "--device", "cpu"])
    assert st["tokens_out"] == 6
    assert "served 3 requests on cpu" in capsys.readouterr().out
    # --snn-artifact takes the SNN role, which refuses to leave the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "yi-6b", "--snn-artifact", "x.npz"])


# -------------------------------------------------------------- token stream
def test_token_pipeline_matches_jax():
    kw = dict(vocab=1000, seq_len=64, global_batch=4, n_hosts=2, seed=5)
    a = TokenPipeline(TokenPipelineConfig(**kw)).global_batch_at(3)
    b = JPipeline(JPipelineConfig(**kw)).global_batch_at(3)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(a[key], b[key])
