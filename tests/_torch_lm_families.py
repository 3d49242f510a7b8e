"""Checks shared by the port's MoE, SSM and frontend test files: one LM
family of the port against the JAX package's at reduced size on the CPU,
parameters carried across by ``lm_from_jax``; an audio or vision model
takes its frontend stub (``frontend``) in the forward.

Tolerances: float32 logits and aux within ``LOGIT_TOL`` of JAX's (the two
frameworks sum in different orders), cache entries within 1e-5, the port's
own decode against its forward within ``DECODE_TOL`` (``tests/
test_models.py``'s bound), greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models.model import LM as JLM
from repro.serving.engine import ServeEngine as JServeEngine
from repro.training import lm_step as jlm_step
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import lm_step

LOGIT_TOL = 1e-4
DECODE_TOL = 2e-3
#: leaves JAX draws in float32 whatever the model's dtype
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")


def configs(arch: str, **changes):
    """(JAX's reduced config, the port's), with the same ``changes``."""
    return (dataclasses.replace(jregistry.reduced(jregistry.get_config(arch)),
                                **changes),
            dataclasses.replace(registry.reduced(registry.get_config(arch)),
                                **changes))


def pair(cfg_j, cfg_t, seed, dtype=jnp.float32):
    """(JAX LM, its params in ``dtype``, the port's LM holding the same)."""
    jlm = JLM(cfg_j)
    params = jlm.init_params(jax.random.PRNGKey(seed), dtype)
    lm = lm_from_jax(cfg_t, jax.tree.map(np.asarray, params), device="cpu")
    return jlm, params, lm


def tokens(vocab, B=2, S=24, seed=2):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def frontend(cfg, B=2, seed=6) -> dict:
    """The forward's frontend stub for ``cfg``, numpy float32 from a seed:
    Whisper's ``enc_frames`` (B, cross_len, d), InternVL's ``patch_embeds``
    (B, n_patches, d); nothing for the other families."""
    rng = np.random.RandomState(seed)
    if cfg.enc_layers:
        return {"enc_frames": rng.randn(B, cfg.cross_len, cfg.d_model)
                .astype(np.float32)}
    if cfg.frontend == "vision":
        return {"patch_embeds": rng.randn(B, cfg.n_patches, cfg.d_model)
                .astype(np.float32)}
    return {}


def jax_prefill(jlm, params, toks, s_max, **cache_kw):
    """JAX's ``LM.prefill`` (token by token through ``decode_step``), with
    the step jitted once so the loop runs at test speed."""
    step = jax.jit(jlm.decode_step)
    cache = jlm.init_cache(toks.shape[0], s_max, dtype=params["embed"].dtype,
                           **cache_kw)
    logits = None
    for t in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
    return logits, cache


def check_forward(jlm, params, lm):
    """Logits and the summed aux loss within LOGIT_TOL of JAX's, with the
    model's frontend stub; the CPU launches no kernel."""
    toks = tokens(lm.cfg.vocab)
    stub = frontend(lm.cfg)
    want, aux_j = jlm.forward(params, jnp.asarray(toks),
                              **{k: jnp.asarray(v) for k, v in stub.items()})
    fa_ops.reset_launches()
    got, aux = lm.forward(torch.from_numpy(toks),
                          **{k: torch.from_numpy(v) for k, v in stub.items()})
    assert got.shape == (2, 24, lm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert (float(aux) > 0) == bool(lm.cfg.n_experts)
    assert fa_ops.LAUNCHES == {"flash_attention": 0,
                               "flash_attention_sm90": 0,
                               "flash_attention_bwd": 0}


def check_prefill(jlm, params, lm, s_max=32, **cache_kw):
    """Token-by-token prefill: the last logits and every cache entry (K, V,
    cross K and V, SSM state and conv window) against JAX's, then one more
    step through the serve-step factories."""
    toks = tokens(lm.cfg.vocab)
    want, jcache = jax_prefill(jlm, params, toks, s_max, **cache_kw)
    got, cache = lm.prefill(torch.from_numpy(toks), s_max=s_max, **cache_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert cache["len"] == int(jcache["len"]) == toks.shape[1]
    assert set(cache["blocks"]) == set(jcache["blocks"])
    for key, entry in cache["blocks"].items():
        assert set(entry) == set(jcache["blocks"][key])
        for name, t in entry.items():
            want_t = np.asarray(jcache["blocks"][key][name])
            assert t.shape == want_t.shape, (key, name)
            np.testing.assert_allclose(t.float().numpy(),
                                       want_t.astype(np.float32),
                                       rtol=1e-5, atol=1e-5)
    nxt = toks[:, :1]
    want1, _ = jlm_step.make_serve_step(jlm)(params, jcache, jnp.asarray(nxt))
    got1, cache = lm_step.make_serve_step(lm)(cache, torch.from_numpy(nxt))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert cache["len"] == toks.shape[1] + 1


def check_decode_matches_forward(lm):
    toks = torch.from_numpy(tokens(lm.cfg.vocab, seed=3))
    full, _ = lm.forward(toks)
    last, _ = lm.prefill(toks, s_max=32)
    assert float((full[:, -1] - last[:, 0]).abs().max()) < DECODE_TOL


def prompts(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, rng.randint(4, 16)).astype(np.int32)
            for _ in range(n)]


def check_serve_engine(jlm, params, lm):
    ps = prompts(lm.cfg.vocab, 4)
    jeng = JServeEngine(jlm, params, max_batch=3, s_max=64)
    want = jeng.generate(ps, max_new=6)
    eng = ServeEngine(lm, max_batch=3, s_max=64, device="cpu")
    assert eng.generate(ps, max_new=6) == want
    assert eng.stats()["tokens_out"] == jeng.stats()["tokens_out"]


def check_launcher(arch, capsys):
    st = serve.main(["--arch", arch, "--reduced", "--requests", "3",
                     "--max-new", "2", "--device", "cpu"])
    assert st["tokens_out"] == 6
    assert "served 3 requests on cpu" in capsys.readouterr().out


def check_float32_leaves(arch):
    """A bf16 model keeps the router, A_log, D and dt_bias in float32, and
    its decode cache's SSM state, through both ``init_params`` and
    ``lm_from_jax``; every other leaf is bf16."""
    cfg_j, cfg_t = configs(arch)
    built = LM(cfg_t, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    _, params, carried = pair(cfg_j, cfg_t, seed=4, dtype=jnp.bfloat16)
    seen = set()
    for lm in (built, carried):
        assert lm.dtype == torch.bfloat16
        for name, w in lm.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            want = torch.float32 if leaf in FLOAT32_LEAVES else torch.bfloat16
            assert w.dtype == want, name
            seen.add(leaf)
        for entry in lm.init_cache(2, 16)["blocks"].values():
            if "state" in entry:
                assert entry["state"].dtype == torch.float32
                assert entry["conv"].dtype == torch.bfloat16
    for leaf in FLOAT32_LEAVES:
        in_jax = [x for path, x in jax.tree_util.tree_leaves_with_path(params)
                  if path[-1].key == leaf]
        assert all(x.dtype == jnp.float32 for x in in_jax)
        assert bool(in_jax) == (leaf in seen)
    return seen
