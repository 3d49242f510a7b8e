"""The backward of kernel 8 on the CPU: ``flash_attention_bwd_ref`` (the
plain version of ``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of the
JAX package's ``flash_attention_ref`` on the same inputs and cotangent, and
``FlashAttention`` (the autograd Function the model's attention goes
through) running that plain version on CPU tensors and launching nothing.

Tolerances: float32 within 2e-5 (kernel 8's forward tolerance; the two
compute the same sums in another order), bfloat16 within 2e-2. The CUDA
kernel is held to this plain version by chip_smoke.py phase 5b on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_len
CASES = {
    "causal": (1, 4, 4, 40, 40, 16, True, None, 0, None),
    "gqa+offset": (2, 8, 2, 24, 48, 16, True, None, 24, None),
    "window": (1, 4, 1, 64, 64, 16, True, 12, 0, None),
    "kv_len": (2, 8, 1, 20, 64, 16, True, None, 40, 47),
    "no visible key": (1, 4, 2, 8, 8, 16, True, 2, 20, None),
    "empty prefix": (1, 2, 1, 32, 32, 8, True, 4, -6, None),
    "non-causal": (1, 2, 2, 24, 56, 16, False, None, 0, None),
    "non-causal kv_len": (1, 4, 2, 16, 40, 24, False, None, 0, 29),
}


def _inputs(case, dtype, seed=0):
    B, Hq, Hkv, Sq, Skv, D = CASES[case][:6]
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, Hq, Sq, D), rng.randn(B, Hkv, Skv, D),
            rng.randn(B, Hkv, Skv, D), rng.randn(B, Hq, Sq, D)]
    return [a.astype(np.float32) for a in arrs]


def _kw(case):
    causal, window, q_offset, kv_len = CASES[case][6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)


def _jax_grads(q, k, v, dout, dtype, kw):
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda q_, k_, v_: j_ref(q_, k_, v_, **kw),
                       *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return np.asarray(out, np.float32), [
        np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout, jdt))]


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_jax_vjp(case, dtype):
    q, k, v, dout = _inputs(case, dtype)
    kw = _kw(case)
    out_j, want = _jax_grads(q, k, v, dout, dtype, kw)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, dout)]
    out = ref.flash_attention_ref(t[0], t[1], t[2], **kw)
    got = ref.flash_attention_bwd_ref(t[0], t[1], t[2], out, t[3], **kw)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), out_j, rtol=tol, atol=tol)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, t[:3]):
        assert g.dtype == tdt and g.shape == x.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol,
                                   err_msg=f"{case} {dtype} {name}")


def test_rows_that_see_no_key_give_dv_only():
    """A query that sees no key has a uniform softmax over every key: its
    dout / Skv reaches every key's dv, and nothing reaches dq or dk."""
    q, k, v, dout = map(torch.from_numpy, _inputs("no visible key", "float32"))
    kw = _kw("no visible key")
    out = ref.flash_attention_ref(q, k, v, **kw)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    assert not dq.any() and not dk.any()
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    want = dout.reshape(B, Hkv, Hq // Hkv, Sq, D).sum(dim=(2, 3)) / Skv
    torch.testing.assert_close(dv, want[:, :, None].expand_as(dv),
                               rtol=1e-6, atol=1e-6)


def test_the_plain_forward_refuses_autograd():
    """Why the explicit plain backward exists: the forward's in-place
    softmax overwrites what autograd would need."""
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs("causal", "float32"))
    with pytest.raises(RuntimeError, match="inplace operation"):
        ref.flash_attention_ref(q, k, v, causal=True).sum().backward()


@pytest.mark.parametrize("case", ["gqa+offset", "no visible key",
                                  "non-causal kv_len"])
def test_function_runs_the_plain_backward_on_the_cpu(case, monkeypatch):
    """``FlashAttention`` (and ``chunked_attention`` through it) gives the
    plain backward's gradients on CPU tensors, through the model's movedim
    views, and launches no kernel."""
    q, k, v, dout = _inputs(case, "float32")
    kw = _kw(case)
    # (B, S, H, D) storage handed over as (B, H, S, D) views, as the model
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.swapaxes(1, 2)))
                  .requires_grad_() for a in (q, k, v))
    ops.reset_launches()
    calls = []
    real = ref.flash_attention_bwd_ref
    monkeypatch.setattr(ref, "flash_attention_bwd_ref",
                        lambda *a, **k_: calls.append(1) or real(*a, **k_))
    out = layers.chunked_attention(tq.movedim(1, 2), tk.movedim(1, 2),
                                   tv.movedim(1, 2), **kw)
    out.backward(torch.from_numpy(dout))
    assert calls == [1]
    assert all(n == 0 for n in ops.LAUNCHES.values())
    want = real(*map(torch.from_numpy, (q, k, v)),
                ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                        **kw),
                torch.from_numpy(dout), **kw)
    for name, x, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        torch.testing.assert_close(x.grad.movedim(1, 2), w, rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("grad", [False, True])
def test_serving_calls_the_wrapper_and_training_the_function(grad,
                                                             monkeypatch):
    """``chunked_attention`` goes through ``FlashAttention`` only where a
    gradient is recorded; under ``no_grad`` (serving) it calls the
    forward's wrapper directly, with the same result."""
    q, k, v, _ = map(torch.from_numpy, _inputs("gqa+offset", "float32"))
    kw = _kw("gqa+offset")
    applied = []
    real = ops.FlashAttention.apply
    monkeypatch.setattr(ops.FlashAttention, "apply",
                        lambda *a: applied.append(1) or real(*a))
    q.requires_grad_(True)
    with torch.set_grad_enabled(grad):
        out = layers.chunked_attention(q, k, v, **kw)
    assert applied == ([1] if grad else [])
    assert (out.grad_fn is not None) == grad
    torch.testing.assert_close(out.detach(), ref.flash_attention_ref(
        q.detach(), k, v, **kw), rtol=0, atol=0)


def test_bwd_wrapper_checks_its_inputs():
    q, k, v, dout = map(torch.from_numpy, _inputs("causal", "float32"))
    out = ref.flash_attention_ref(q, k, v)
    with pytest.raises(ValueError, match="q's shape"):
        ops.flash_attention_bwd(q, k, v, out[:, :, :-1], dout)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention_bwd(q, k, v, out, dout.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention_bwd(*(t.double() for t in (q, k, v, out, dout)))
    assert "flash_attention_bwd" in ops.LAUNCHES
