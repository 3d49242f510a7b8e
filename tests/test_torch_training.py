"""The port's trainers against the JAX package's on the CPU, from JAX's own
initial weights carried across (``jax.random`` bits cannot be drawn in
torch): ``train_dense_proxy`` on 512 procedural MNIST images (readout
10 x 15, batch 64, one epoch: 8 steps) and ``train_surrogate`` at T 8 on
256 images (batch 128: 2 steps).

Tolerances: each step's loss within rtol 1e-5; the dense proxy's final
weights within atol 1e-5 and its accuracies equal. One Adam update of the
wrong sign moves an element by 2·lr (6e-3 dense, 4e-3 surrogate), far
outside both. The surrogate's logits within atol 1e-5, its first gradient
within atol 2e-7, and its weights after 2 steps within atol 1e-4: the two
packages' float32 gradients differ by rounding, and Adam's second step
divides by the root of the second moment, which on an element whose
gradient nearly cancels makes that rounding a visible share of an update
(still 40 times below a flipped one).
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snn as jsnn
from repro.training import ttfs_trainer as jt
from repro_torch.core import snn
from repro_torch.data import mnist
from repro_torch.training import ttfs_trainer as tt

SUR = dict(t_steps=8, tau=16.0, threshold=1.0, beta=5.0)


@pytest.fixture(scope="module")
def data():
    return mnist.generate(512, 7)


class _StepRecorder:
    """Stands in for the ``jax`` module inside JAX's trainer: every jitted
    train step's loss (its third output) is recorded in order."""

    def __init__(self, losses: list):
        self._losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        compiled = jax.jit(fn)

        def run(*args):
            out = compiled(*args)
            if isinstance(out, tuple) and len(out) == 3:
                self._losses.append(float(out[2]))
            return out
        return run


def _jax_run(monkeypatch, trainer, *args, **kw):
    losses = []
    with monkeypatch.context() as m:
        m.setattr(jt, "jax", _StepRecorder(losses))
        res = trainer(*args, **kw)
    return res, losses


@pytest.fixture(scope="module")
def dense_runs(data):
    x, y = data
    kw = dict(test_images=x[:256], test_labels=y[:256], epochs=1, batch=64)
    with pytest.MonkeyPatch.context() as mp:
        jres, jlosses = _jax_run(mp, jt.train_dense_proxy, x, y, **kw)
    w0 = np.asarray(jsnn.Linear(784, 150, key=jax.random.PRNGKey(0))
                    .params["w"])                  # JAX's init for seed 0
    res = tt.train_dense_proxy(x, y, w_init=w0, device="cpu", **kw)
    return jres, jlosses, res


def test_dense_proxy_steps_and_losses_equal_jax(dense_runs):
    jres, jlosses, res = dense_runs
    assert res.steps == jres.steps == len(jlosses) == len(res.losses) == 8
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-5, atol=0)


def test_dense_proxy_weights_and_accuracies_equal_jax(dense_runs):
    jres, _, res = dense_runs
    got = res.model.linear_layers()[0].w.detach().numpy()
    want = np.asarray(jres.model.body.layers[0].params["w"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (res.train_acc, res.test_acc) == (jres.train_acc, jres.test_acc)
    assert res.model.encode_t == jres.model.encode_t == 32
    assert asdict(res.model.lif_layers()[0].spec) == \
        asdict(jres.model.lif_layers()[0].spec)


def _jax_surrogate_logits(w, x, t_steps, tau, threshold, beta, g=10, p=15):
    """The forward of ``repro.training.ttfs_trainer.train_surrogate``
    (``src/repro/training/ttfs_trainer.py:123-142``), which the trainer
    keeps inside its body."""
    decay = float(np.exp(-1.0 / tau))
    tspike = jnp.floor((1.0 - x) * (t_steps - 1))
    frames = (tspike[:, None, :] == jnp.arange(t_steps)[None, :, None])
    frames = frames.astype(jnp.float32) * (x > 0)[:, None, :]
    cur = jnp.einsum("btn,no->bto", frames, w)

    def step(v, i_t):
        v = decay * v + i_t
        return v, jax.nn.sigmoid(beta * (v - threshold))

    _, s_t = jax.lax.scan(step, jnp.zeros((x.shape[0], w.shape[1])),
                          jnp.moveaxis(cur, 1, 0))
    s_t = jnp.moveaxis(s_t, 0, 1)
    w_time = (t_steps - jnp.arange(t_steps, dtype=jnp.float32)) / t_steps
    score = jnp.max(s_t * w_time[None, :, None], axis=1)
    return jnp.max(score.reshape(-1, g, p), axis=-1)


def _jax_surrogate_w0():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (784, 150),
                                        jnp.float32) / np.sqrt(784))


def _port_logits(w, x):
    return tt.surrogate_logits(w, x, t_steps=SUR["t_steps"],
                               decay=float(np.exp(-1.0 / SUR["tau"])),
                               threshold=SUR["threshold"], beta=SUR["beta"],
                               g=10, p=15)


def test_surrogate_forward_and_gradient_equal_jax(data):
    x, y = data[0][:128], data[1][:128]
    w0 = _jax_surrogate_w0()
    want = np.asarray(_jax_surrogate_logits(jnp.asarray(w0), jnp.asarray(x),
                                            **SUR))
    w = torch.tensor(w0, requires_grad=True)
    got = _port_logits(w, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)

    def jloss(w_):
        logp = jax.nn.log_softmax(_jax_surrogate_logits(
            w_, jnp.asarray(x), **SUR) * 8.0)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=1))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(w0)))
    loss = tt._cross_entropy(got * 8.0, torch.from_numpy(y).long())
    (grad,) = torch.autograd.grad(loss, w)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=2e-7)


def test_surrogate_training_equals_jax(data, monkeypatch):
    x, y = data[0][:256], data[1][:256]
    kw = dict(epochs=1, batch=128, t_steps=SUR["t_steps"])
    jres, jlosses = _jax_run(monkeypatch, jt.train_surrogate, x, y, **kw)
    res = tt.train_surrogate(x, y, w_init=_jax_surrogate_w0(), device="cpu",
                             **kw)
    assert res.steps == jres.steps == 2
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-5, atol=0)
    got = res.model.linear_layers()[0].w.detach().numpy()
    want = np.asarray(jres.model.body.layers[0].params["w"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert res.train_acc == jres.train_acc
    assert asdict(res.model.lif_layers()[0].spec) == \
        asdict(jres.model.lif_layers()[0].spec)


def test_trainers_draw_from_a_seeded_generator():
    """Without a carried init the weights come from a generator seeded by
    ``seed``: the same seed trains the same weights, another does not."""
    x, y = mnist.generate(128, 3)
    kw = dict(epochs=1, batch=64, device="cpu")
    a = tt.train_dense_proxy(x, y, seed=1, **kw)
    b = tt.train_dense_proxy(x, y, seed=1, **kw)
    c = tt.train_dense_proxy(x, y, seed=2, **kw)
    wa, wb, wc = (r.model.linear_layers()[0].w for r in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert a.losses == b.losses and len(a.losses) == a.steps == 2
    with pytest.raises(ValueError, match="w_init"):
        tt.train_dense_proxy(x, y, w_init=np.zeros((3, 150)), **kw)
    assert isinstance(a.model, snn.SNN)
