"""Authoring in the port against the JAX package on the CPU: quantization
and the leak shift (exact, edge inputs included), the deployment planner and
its padded block layout (exact, ``vmem_util`` included), ``gen_config``
(equal dicts), the JAX params pytree carried into a port ``SNN`` (equal
forwards, atol 1e-6 in float32) and AdamW (10 updates within rtol 1e-6 /
atol 1e-7)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codesign as jcodesign
from repro.core import deploy as jdeploy
from repro.core import quant as jquant
from repro.core import snn as jsnn
from repro.training import optim as joptim
from repro_torch.core import codesign, deploy, quant, snn
from repro_torch.training import optim

PLAN_SHAPES = [(784, 150), (8, 1), (300, 129), (128, 256)]


def _weights():
    rng = np.random.RandomState(5)
    yield "normal", (rng.randn(784, 150) * 0.05).astype(np.float32)
    yield "zero", np.zeros((8, 3), np.float32)
    yield "large", (rng.randn(16, 4) * 1e7).astype(np.float32)
    w = rng.randn(10, 6).astype(np.float32)
    w[0, 0] = -3.0                                   # the negative extreme
    yield "tie at -amax", np.where(w > 2.9, 3.0, w).astype(np.float32)
    yield "halves", (np.arange(-254, 255, 2, dtype=np.float32)
                     / 2).reshape(1, -1)             # round-half-even grid


@pytest.mark.parametrize("name,w", list(_weights()),
                         ids=[n for n, _ in _weights()])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_equals_jax(name, w, bits):
    """Exact: the same int8 array and the same Python float scale."""
    got, scale = quant.quantize_weights(w, bits=bits)
    want, jscale = jquant.quantize_weights(w, bits=bits)
    assert got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want) and scale == jscale
    deq = quant.dequantize(got, scale)
    assert deq.dtype == np.float32
    assert np.array_equal(deq, jquant.dequantize(want, jscale))


@pytest.mark.parametrize("tau", [0.0, -3.0, np.inf, 1e7, 1e3, 64.0, 16.0,
                                 4.0, 1.0, 0.5, 1e-3])
def test_leak_shift_from_tau_equals_jax(tau):
    assert quant.leak_shift_from_tau(tau) == jquant.leak_shift_from_tau(tau)
    assert quant.INT32_NEVER_FIRE == jquant.INT32_NEVER_FIRE
    assert quant.INT8_MAX == jquant.INT8_MAX


def test_leak_shift_refuses_nan_like_jax():
    for mod in (quant, jquant):
        with pytest.raises(ValueError, match="NaN"):
            mod.leak_shift_from_tau(float("nan"))


@pytest.mark.parametrize("n_in,n_out", PLAN_SHAPES)
def test_plan_and_blocked_layout_equal_jax(n_in, n_out):
    """Every number of the plan (``vmem_util`` and ``limiter`` are written
    into the artifact's meta) and every array of the layout, exactly."""
    got, want = codesign.plan(n_in, n_out), jcodesign.plan(n_in, n_out)
    for f in dataclasses.fields(want):
        if f.name != "notes":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    rng = np.random.RandomState(n_in + n_out)
    w = rng.randint(-127, 128, (n_in, n_out)).astype(np.int8)
    thr = rng.randint(1, 5000, n_out).astype(np.int32)
    gids = np.arange(n_out, dtype=np.int32) // max(1, n_out // 10)
    lay = codesign.blocked_layout(w, thr, gids, got.lane)
    jlay = jcodesign.blocked_layout(w, thr, gids, want.lane)
    assert sorted(lay) == sorted(jlay)
    for k in jlay:
        assert lay[k].dtype == jlay[k].dtype and \
            np.array_equal(lay[k], jlay[k]), k


def test_plan_budget_is_the_artifact_formats():
    """The budget is format, not a device: its table says so."""
    b = codesign.ARTIFACT_PLAN_BUDGET
    assert (b.lane, b.vmem_bytes, b.hbm_bytes) == (128, 32 * 2**20,
                                                   16 * 2**30)
    table = codesign.plan(784, 150).table()
    assert "format budget" in table and "VMEM" not in table.split(
        "Primary limiter")[0]


def _models(tau, readout, encode_t, x_min):
    jm = jsnn.SNN(jsnn.Sequential(jsnn.Linear(784, 150), jsnn.LIF(tau=tau)),
                  readout=readout and jsnn.ReadoutSpec(*readout),
                  encode_t=encode_t, x_min=x_min)
    m = snn.SNN(snn.Sequential(snn.Linear(784, 150, device="cpu"),
                               snn.LIF(tau=tau)),
                readout=readout and snn.ReadoutSpec(*readout),
                encode_t=encode_t, x_min=x_min)
    return jm, m


@pytest.mark.parametrize("tau,readout,encode_t,x_min", [
    (16.0, None, 32, 1.0 / 255.0), (0.0, (15, 10, "zero"), 20, 0.01),
    (np.inf, (3, 50, "membrane"), 8, 1.0 / 255.0)])
def test_gen_config_equals_jax(tau, readout, encode_t, x_min):
    jm, m = _models(tau, readout, encode_t, x_min)
    assert deploy.gen_config(m) == jdeploy.gen_config(jm)


def test_gen_config_refuses_deeper_models_like_jax():
    m = snn.SNN(snn.Sequential(snn.Linear(4, 4, device="cpu"),
                               snn.Linear(4, 4, device="cpu")))
    with pytest.raises(NotImplementedError, match="exactly one"):
        deploy.gen_config(m)


def test_carried_params_give_the_jax_forward():
    """JAX's seeded init carried across: equal float32 forwards (atol
    1e-6); the LIF stage is the identity in both."""
    key = jax.random.PRNGKey(3)
    jm = jsnn.SNN(jsnn.Sequential(jsnn.Linear(784, 150, key=key),
                                  jsnn.LIF()))
    m = snn.SNN(snn.Sequential(snn.Linear(784, 150, device="cpu"),
                               snn.LIF()))
    snn.load_params(m, [{k: np.asarray(v) for k, v in p.items()}
                        for p in jm.params])
    x = np.random.RandomState(0).rand(64, 784).astype(np.float32)
    got = m(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jm(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert [type(layer) for layer in m.lif_layers()] == [snn.LIF]
    assert m.linear_layers()[0].w.shape == (784, 150)


def test_linear_init_and_load_params_checks():
    """A seeded generator draws Kaiming-uniform weights (bound 1/sqrt(in)),
    the same on a fresh generator with the same seed; no generator leaves
    the layer untrained; a mis-shaped carry raises."""
    a = snn.Linear(784, 150, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    b = snn.Linear(784, 150, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    assert torch.equal(a.w, b.w) and a.w.dtype == torch.float32
    assert float(a.w.detach().abs().max()) <= 1 / np.sqrt(784)
    untrained = snn.Linear(4, 2, device="cpu")
    assert untrained.w is None
    with pytest.raises(RuntimeError, match="no weights"):
        untrained(torch.zeros(1, 4))
    m = snn.SNN(snn.Sequential(untrained, snn.LIF()))
    with pytest.raises(RuntimeError, match="train first"):
        deploy.export(m, calib_images=np.zeros((2, 4), np.float32),
                      calib_labels=np.zeros(2, np.int32), device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        snn.load_params(m, [{"w": np.zeros((2, 4))}, {}])


def test_adamw_equals_jax():
    """10 updates on seeded float32 params and grads: within rtol 1e-6 /
    atol 1e-7 of JAX's (params and both moments)."""
    rng = np.random.RandomState(11)
    shapes = {"w": (64, 30), "b": (30,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, 1)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(10)]
    jopt = joptim.adamw(lr=3e-3, weight_decay=1e-4)
    opt = optim.adamw(lr=3e-3, weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    for g in grads:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tp, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
    assert ts["step"] == int(js["step"]) == 10
    for k in shapes:
        assert tp[k].dtype == torch.float32
        for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                          (ts["v"][k], js["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
