"""The port's Mamba-2 / SSD mixer (``repro_torch.models.mamba2``) and its SSM
models (Mamba2-780M, and Jamba's hybrid period of one attention and seven
mamba sublayers with MoE every second one) against the JAX package on the
CPU.

``ssd_chunked`` is held to JAX's and to ``ssd_naive_ref`` within 1e-4
(JAX's own bound, ``tests/test_models.py::test_ssd_chunked_vs_naive``);
the mixer and the decode step to JAX's within 1e-5; the models at reduced
size to the tolerances of ``_torch_lm_families``. The conv window's rows are
float32 products ``x @ in_proj``, which XLA and torch sum in orders that
move with the host's thread count (a last-ulp difference, 5.96e-8, on 221 of
960 elements seen on one host): they are held to JAX's within 1e-5 and, bit
for bit, to the port's own product and to the shifted previous window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_families as fam
from repro.configs import registry as jregistry
from repro.models import mamba2 as jm
from repro.models.model import LM as JLM
from repro_torch.configs import registry
from repro_torch.models import mamba2 as tm

ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")
SSD_TOL = 1e-4
MIXER_TOL = 1e-5


def _ssd_inputs(S, H=4, G=1, P=8, N=16, B=2, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    a = (-np.abs(rng.randn(B, S, H)) * 0.5).astype(np.float32)
    B_ = (rng.randn(B, S, G, N) * 0.3).astype(np.float32)
    C_ = (rng.randn(B, S, G, N) * 0.3).astype(np.float32)
    return x, a, B_, C_


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------- SSD
@pytest.mark.parametrize("S,chunk,G,init", [
    (64, 16, 1, False),          # a chunk multiple
    (60, 16, 1, False),          # self-padded to 64
    (37, 16, 2, True),           # padded, 2 groups over 4 heads, init state
    (12, 32, 1, True),           # one chunk shorter than the chunk length
    (48, 16, 4, False),          # one group a head
])
def test_ssd_chunked_matches_jax_and_the_naive_recurrence(S, chunk, G, init):
    x, a, B_, C_ = _ssd_inputs(S, G=G)
    s0 = (np.random.RandomState(9).randn(2, 4, 16, 8).astype(np.float32)
          if init else None)
    y_j, s_j = jm.ssd_chunked(x, a, B_, C_, chunk=chunk, init_state=s0)
    y, s = tm.ssd_chunked(*_t(x, a, B_, C_), chunk,
                          init_state=None if s0 is None else
                          torch.from_numpy(s0))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (2, S, 4, 8) and s.shape == (2, 4, 16, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=SSD_TOL,
                               atol=SSD_TOL)
    if not init:                 # the oracle starts from a zero state
        naive = tm.ssd_naive_ref(*_t(x, a, B_, C_))
        np.testing.assert_allclose(y.numpy(), naive.numpy(), rtol=SSD_TOL,
                                   atol=SSD_TOL)


def test_ssd_naive_ref_matches_jax():
    x, a, B_, C_ = _ssd_inputs(33, G=2)
    want = jm.ssd_naive_ref(*map(jnp.asarray, (x, a, B_, C_)))
    got = tm.ssd_naive_ref(*_t(x, a, B_, C_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_init_state_carries_the_sequence_on():
    """The sequence in two halves, the second started from the first's
    final state, equals the whole."""
    x, a, B_, C_ = _ssd_inputs(50)
    X, A, Bt, Ct = _t(x, a, B_, C_)
    y, s = tm.ssd_chunked(X, A, Bt, Ct, 16)
    y1, s1 = tm.ssd_chunked(X[:, :20], A[:, :20], Bt[:, :20], Ct[:, :20], 16)
    y2, s2 = tm.ssd_chunked(X[:, 20:], A[:, 20:], Bt[:, 20:], Ct[:, 20:], 16,
                            init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=SSD_TOL,
                               atol=SSD_TOL)
    torch.testing.assert_close(s2, s, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_writes_no_three_operand_einsum(monkeypatch):
    """The two three-operand contractions are written as explicit two-step
    products: ``ssd_chunked`` calls no ``torch.einsum``, whose contraction
    path could materialise a (B, nc, Q, Q, H, P) tensor."""
    def refuse(*args, **kwargs):
        raise AssertionError("ssd_chunked called torch.einsum")
    monkeypatch.setattr(torch, "einsum", refuse)
    tm.ssd_chunked(*_t(*_ssd_inputs(40)), 16)


def test_mask_goes_on_before_exp():
    """Strongly negative decays make the future positions' segment sums
    large and positive: masked after exp they would overflow to inf (and
    inf * 0 is NaN); masked before, every output is finite."""
    x, a, B_, C_ = _ssd_inputs(32)
    a = (a - 60.0).astype(np.float32)
    y, s = tm.ssd_chunked(*_t(x, a, B_, C_), 32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_j, _ = jm.ssd_chunked(x, a, B_, C_, chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=SSD_TOL,
                               atol=SSD_TOL)


# ------------------------------------------------------------------ mixer
@pytest.fixture(scope="module")
def mixer():
    """The reduced Mamba2 config, one mamba sublayer's float32 parameters
    drawn by JAX, and an input (B 2, S 21: not a chunk multiple)."""
    cfg_j = jregistry.reduced(jregistry.get_config("mamba2-780m"))
    cfg_t = registry.reduced(registry.get_config("mamba2-780m"))
    params = JLM(cfg_j).init_params(jax.random.PRNGKey(6), jnp.float32)
    p = {k: np.asarray(v)[0] for k, v in params["blocks"]["0:mamba"].items()}
    p["conv_b"] = np.random.RandomState(2).randn(*p["conv_b"].shape).astype(
        np.float32) * 0.1
    p["dt_bias"] = np.random.RandomState(3).randn(*p["dt_bias"].shape).astype(
        np.float32)
    x = np.random.RandomState(1).randn(2, 21, cfg_t.d_model).astype(
        np.float32)
    return cfg_j, cfg_t, p, x


def _tp(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _conv_rows(x, p, cfg):
    """The conv channels (xBC) of ``x @ in_proj`` for x (B, S, d): the raw
    rows a conv window holds, as the port's own product gives them."""
    xBC = torch.from_numpy(x) @ torch.from_numpy(np.array(p["in_proj"]))
    ch = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_d_state
    return xBC[..., cfg.d_inner:cfg.d_inner + ch]


def _state(st):
    return tm.SSMState(state=torch.from_numpy(np.array(st.state)),
                       conv=torch.from_numpy(np.array(st.conv)))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_mixer_matches_jax(mixer, with_state):
    cfg_j, cfg_t, p, x = mixer
    st_j = st = None
    if with_state:               # a state left by a first stretch of tokens
        _, st_j = jm.mamba2_mixer(x[:, :9], p, cfg_j, return_state=True)
        st = _state(st_j)
        x = x[:, 9:]
    want, new_j = jm.mamba2_mixer(x, p, cfg_j, state=st_j, return_state=True)
    got, new = tm.mamba2_mixer(torch.from_numpy(x), _tp(p), cfg_t, state=st,
                               return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MIXER_TOL,
                               atol=MIXER_TOL)
    np.testing.assert_allclose(new.state.numpy(), np.asarray(new_j.state),
                               rtol=MIXER_TOL, atol=MIXER_TOL)
    np.testing.assert_allclose(new.conv.numpy(), np.asarray(new_j.conv),
                               rtol=MIXER_TOL, atol=MIXER_TOL)
    K1 = cfg_t.ssm_conv - 1         # the window: the last K - 1 raw rows
    assert torch.equal(new.conv, _conv_rows(x, p, cfg_t)[:, -K1:])
    assert torch.equal(tm.mamba2_mixer(torch.from_numpy(x), _tp(p), cfg_t,
                                       state=st), got)


def test_mamba2_decode_step_matches_jax(mixer):
    """Five decode steps from the state the mixer leaves after 16 tokens,
    each against JAX's step, and the port's steps against its own mixer on
    the whole sequence."""
    cfg_j, cfg_t, p, x = mixer
    _, st_j = jm.mamba2_mixer(x[:, :16], p, cfg_j, return_state=True)
    st = _state(st_j)
    outs = []
    for t in range(16, 21):
        want, st_j = jm.mamba2_decode_step(x[:, t:t + 1], p, cfg_j, st_j)
        prev = st.conv
        got, st = tm.mamba2_decode_step(torch.from_numpy(x[:, t:t + 1]),
                                        _tp(p), cfg_t, st)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=MIXER_TOL, atol=MIXER_TOL)
        np.testing.assert_allclose(st.state.numpy(), np.asarray(st_j.state),
                                   rtol=MIXER_TOL, atol=MIXER_TOL)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(st_j.conv),
                                   rtol=MIXER_TOL, atol=MIXER_TOL)
        # exact where the port is exact: the window shifts by one row and
        # takes the port's own product of the new token as its newest row
        assert torch.equal(st.conv[:, :-1], prev[:, 1:])
        assert torch.equal(st.conv[:, -1], _conv_rows(x[:, t], p, cfg_t))
        outs.append(got)
    whole = tm.mamba2_mixer(torch.from_numpy(x), _tp(p), cfg_t)
    torch.testing.assert_close(torch.cat(outs, dim=1), whole[:, 16:],
                               rtol=1e-4, atol=1e-4)


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
def test_bf16_model_keeps_the_ssm_leaves_and_state_in_float32(arch):
    seen = fam.check_float32_leaves(arch)
    assert {"A_log", "D", "dt_bias"} <= seen
    assert ("router" in seen) == (arch == "jamba-1.5-large-398b")


def test_jamba_period_mixes_attention_mamba_moe_and_dense():
    """Jamba's period: sublayer 0 attention, 1-7 mamba; a MoE FFN on the
    even sublayers, the dense FFN on the odd ones, as JAX builds it."""
    _, params, lm = fam.pair(*fam.configs("jamba-1.5-large-398b"), seed=2)
    cfg = lm.cfg
    assert cfg.period == ("attn",) + ("mamba",) * 7 and cfg.n_periods == 1
    for _, i, kind, sub in lm.sublayers():
        names = set(sub)
        assert ("wq" in names) == (kind == "attn")
        assert ("in_proj" in names) == (kind == "mamba")
        assert ("router" in names) == (i % 2 == 0)
        assert sub["w_gate"].dim() == (3 if i % 2 == 0 else 2)
        assert names == set(params["blocks"][f"{i}:{kind}"])


def test_forward_and_decode_agree_at_a_chunk_boundary():
    """Mamba2 at a chunk of 8 over 24 tokens (three whole chunks) and over
    the decode: the forward's chunked SSD against the token-by-token
    recurrence, and against JAX."""
    jlm, params, lm = fam.pair(*fam.configs("mamba2-780m", ssm_chunk=8),
                               seed=5)
    fam.check_forward(jlm, params, lm)
    fam.check_decode_matches_forward(lm)
    assert lm.cfg.ssm_chunk == 8
