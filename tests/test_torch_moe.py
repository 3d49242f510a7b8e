"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) and its MoE
models (Mixtral-8x7B, Qwen3-MoE) against the JAX package on the CPU.

Routing (``top_i``, ``keep``) is held exactly; outputs within 1e-5 and the
aux within 1e-6 in float32 on the same inputs; the models at reduced size
to the tolerances of ``_torch_lm_families``. The committed
``src/repro_torch/assets/moe_expected.npz`` (JAX's outputs, which
``chip_smoke.py`` holds the card to) is held to JAX and to the port."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_families as fam
from repro.models import moe as jmoe
from repro_torch.models import moe

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSET = os.path.join(ROOT, "src", "repro_torch", "assets", "moe_expected.npz")
ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
OUT_TOL, AUX_TOL = 1e-5, 1e-6


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_fixture",
        os.path.join(ROOT, "scripts", "export_torch_fixture.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


SCRIPT = _load_script()


def _layer(E, k, d=32, f=48, B=2, S=64, router_scale=0.1, seed=5):
    """x and float32 MoE weights, numpy, from a seed."""
    meta = dict(d=d, E=E, k=k, f=f, B=B, S=S, router_scale=router_scale,
                seed=seed)
    return SCRIPT.draw_moe_case(meta)


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _check_against_jax(x, p, E, k, cf):
    """The port's moe_ffn and routing against JAX's on the same inputs;
    returns the port's routing."""
    want, aux_j = jmoe.moe_ffn(x, p, n_experts=E, top_k=k,
                               capacity_factor=cf)
    top_i_j, keep_j = SCRIPT.jax_routing(x, p["router"], n_experts=E,
                                         top_k=k, capacity_factor=cf)
    xt, pt = torch.from_numpy(x), _t(p)
    got, aux = moe.moe_ffn(xt, pt, n_experts=E, top_k=k, capacity_factor=cf)
    r = moe.route(xt, pt["router"], n_experts=E, top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(r.top_i.numpy(), top_i_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=AUX_TOL,
                               atol=AUX_TOL)
    return r


# ------------------------------------------------------------------ capacity
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 8.0])
def test_capacity_equals_jax(factor):
    for S in (1, 7, 64, 128, 4096, 8192):
        for k, E in ((1, 4), (2, 8), (8, 32), (8, 128), (2, 16)):
            assert moe.capacity(S, k, E, factor) == \
                jmoe.capacity(S, k, E, factor)


# ------------------------------------------------------------------ moe_ffn
@pytest.mark.parametrize("E,k", [(8, 2), (32, 8)])
@pytest.mark.parametrize("cf,router_scale", [(8.0, 0.1), (1.0, 2.0)],
                         ids=["drop-free", "skewed-drops"])
def test_moe_ffn_matches_jax(E, k, cf, router_scale):
    x, p = _layer(E, k, router_scale=router_scale)
    r = _check_against_jax(x, p, E, k, cf)
    assert bool(r.keep.all()) == (cf == 8.0)      # the skewed router drops


@pytest.mark.parametrize("E,k", [(8, 2), (128, 8)])
def test_zero_router_ties_take_the_lowest_index_like_jax(E, k):
    """A zero router makes every row a tie over all E experts: JAX's top_k
    takes experts 0..k-1 on every token, and so must the port."""
    x, p = _layer(E, k, S=24)
    p["router"] = np.zeros_like(p["router"])
    r = _check_against_jax(x, p, E, k, cf=1.0)
    assert (r.top_i == torch.arange(k)).all()
    np.testing.assert_allclose(r.top_w.numpy(), 1.0 / k, rtol=1e-6)


@pytest.mark.parametrize("E,k", [(8, 2), (32, 8)])
def test_dense_oracle_matches_jax(E, k):
    x, p = _layer(E, k)
    want = jmoe.moe_ffn_dense_oracle(x, p, n_experts=E, top_k=k)
    got = moe.moe_ffn_dense_oracle(torch.from_numpy(x), _t(p), n_experts=E,
                                   top_k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_equals_the_dense_oracle_where_nothing_drops(dtype):
    """At a drop-free capacity (factor E / k: C = S) the capacity dispatch
    is the dense oracle; in bf16 the buffer is bf16 and the aux float32."""
    E, k = 8, 2
    x, p = _layer(E, k, router_scale=1.0)
    xt = torch.from_numpy(x).to(dtype)
    pt = {n: w if n == "router" else w.to(dtype) for n, w in _t(p).items()}
    got, aux = moe.moe_ffn(xt, pt, n_experts=E, top_k=k,
                           capacity_factor=E / k)
    want = moe.moe_ffn_dense_oracle(xt, pt, n_experts=E, top_k=k)
    assert got.dtype == dtype and aux.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_dropped_assignments_contribute_exactly_zero():
    """At capacity factor 1.0 with a skewed router, each token's output is
    the sum over its kept assignments only of weight x expert(x): the
    dense experts combined with the dropped assignments' weights zeroed."""
    E, k = 8, 2
    x, p = _layer(E, k, router_scale=2.0)
    xt, pt = torch.from_numpy(x), _t(p)
    got, _ = moe.moe_ffn(xt, pt, n_experts=E, top_k=k, capacity_factor=1.0)
    r = moe.route(xt, pt["router"], n_experts=E, top_k=k)
    assert not r.keep.all()
    B, S, d = x.shape
    want = torch.zeros_like(xt)
    keep = r.keep.view(B, S, k)
    for e in range(E):
        y = (torch.nn.functional.silu(xt @ pt["w_gate"][e])
             * (xt @ pt["w_up"][e])) @ pt["w_down"][e]
        w = (r.top_w * ((r.top_i == e) & keep)).sum(-1, keepdim=True)
        want += y * w
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dropped_tokens = ~keep.all(-1)
    assert dropped_tokens.any()


# --------------------------------------------------------- the committed asset
@pytest.mark.parametrize("case", sorted(SCRIPT.MOE_CASES))
def test_moe_asset_equals_jax_and_the_port(case):
    """``moe_expected.npz`` is JAX's moe_ffn today (routing exact, output
    within 1e-5 of a fresh run), and the port's moe_ffn on the CPU equals
    it: routing exactly, the output within 1e-5, the aux within 1e-6."""
    with np.load(ASSET) as z:
        want = {name: z[f"{case}_{name}"] for name in
                ("meta", "out", "aux", "top_i", "keep")}
    meta = json.loads(str(want["meta"]))
    assert meta == SCRIPT.MOE_CASES[case]
    x, p = SCRIPT.draw_moe_case(meta)
    E, k, cf = meta["E"], meta["k"], meta["capacity_factor"]
    fresh, aux_j = jmoe.moe_ffn(x, p, n_experts=E, top_k=k,
                                capacity_factor=cf)
    np.testing.assert_allclose(np.asarray(fresh), want["out"], rtol=OUT_TOL,
                               atol=OUT_TOL)
    top_i_j, keep_j = SCRIPT.jax_routing(x, p["router"], n_experts=E,
                                         top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(top_i_j, want["top_i"])
    np.testing.assert_array_equal(keep_j, want["keep"])
    assert not want["keep"].all()
    r = _check_against_jax(x, p, E, k, cf)
    np.testing.assert_array_equal(r.top_i.numpy(), want["top_i"])
    got, aux = moe.moe_ffn(torch.from_numpy(x), _t(p), n_experts=E,
                           top_k=k, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want["out"], rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=AUX_TOL,
                               atol=AUX_TOL)
    assert os.path.getsize(ASSET) < 1 << 20


# ------------------------------------------------------------------- models
@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = fam.pair(*fam.configs(arch), seed=1)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, models):
    fam.check_forward(*models(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_prefill_match_jax(arch, models):
    fam.check_prefill(*models(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_forward(arch, models):
    fam.check_decode_matches_forward(models(arch)[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_jax(arch, models):
    fam.check_serve_engine(*models(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(arch, capsys):
    fam.check_launcher(arch, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_keeps_the_router_in_float32(arch):
    assert "router" in fam.check_float32_leaves(arch)


def test_mixtral_ring_cache_past_a_window_of_8_matches_jax():
    """Mixtral's sliding window at 8 over 24 tokens: the forward masks by
    the window, the decode cache is an 8-slot ring; both equal JAX's, and
    decode equals the forward (``tests/test_models.py::
    test_swa_ring_buffer_decode_matches_forward``)."""
    jlm, params, lm = fam.pair(*fam.configs("mixtral-8x7b", attn_window=8),
                               seed=3)
    toks = np.random.RandomState(4).randint(0, lm.cfg.vocab, (1, 24)).astype(
        np.int32)
    want_full, _ = jlm.forward(params, jnp.asarray(toks))
    got_full, _ = lm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full),
                               rtol=fam.LOGIT_TOL, atol=fam.LOGIT_TOL)
    want, jcache = fam.jax_prefill(jlm, params, toks, s_max=64)
    got, cache = lm.prefill(torch.from_numpy(toks), s_max=64)
    assert cache["blocks"]["0:attn"]["k"].shape[3] == 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=fam.LOGIT_TOL, atol=fam.LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache["blocks"]["0:attn"][name].numpy(),
            np.asarray(jcache["blocks"]["0:attn"][name]), rtol=1e-5,
            atol=1e-5)
    assert float((got_full[:, -1] - got[:, 0]).abs().max()) < fam.DECODE_TOL


def test_decode_never_drops_at_the_served_capacity():
    """At S 1 the capacity is 8 >= k, so token-by-token decode drops
    nothing even at the full configs' factor 1.0, while the forward at that
    factor drops: the reason forward-vs-decode checks run on a copy of the
    config at a drop-free factor."""
    for arch in ARCHS:
        cfg = fam.registry.get_config(arch)
        assert cfg.capacity_factor == 1.0
        assert moe.capacity(1, cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor) >= cfg.top_k
    x, p = _layer(8, 2, router_scale=2.0)
    r = moe.route(torch.from_numpy(x), torch.from_numpy(p["router"]),
                  n_experts=8, top_k=2, capacity_factor=1.0)
    assert not r.keep.all()
    r1 = moe.route(torch.from_numpy(x[:, :1]), torch.from_numpy(p["router"]),
                   n_experts=8, top_k=2, capacity_factor=1.0)
    assert r1.keep.all()
