"""The backward of kernel 8 on the CPU: ``flash_attention_bwd_ref`` (the
plain version of ``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of the
JAX package's ``flash_attention_ref`` on the same inputs and cotangent, and
``FlashAttention`` (the autograd Function the model's attention goes
through) running that plain version on CPU tensors and launching nothing.
The forward's row statistic (``return_lse=True``), which the backward
kernel recomputes P from, is held to ``jax.nn.logsumexp`` of the masked,
scaled scores times log2(e), with +inf for the rows that see no key.

Tolerances: float32 within 2e-5 (kernel 8's forward tolerance; the two
compute the same sums in another order), bfloat16 within 2e-2; the
statistic, a float32 sum in both types, within 1e-5. The CUDA kernel is held
to this plain version by chip_smoke.py phase 5b on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the statistic against JAX's (atol = rtol): float32 sums in both types
LSE_TOL = 1e-5
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
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="q's shape"):
        ops.flash_attention_bwd(q, k, v, out[:, :, :-1], lse, dout)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention_bwd(q, k, v, out, lse, dout.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention_bwd(*(t.double() for t in (q, k, v, out)), lse,
                                dout.double())
    assert "flash_attention_bwd" in ops.LAUNCHES


def _jax_lse(q, k, kw):
    """JAX's statistic: ``jax.nn.logsumexp`` of the scaled scores over the
    visible keys, times log2(e); (B, Hq, Sq), -inf where no key is seen."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len = Skv if kw["kv_len"] is None else kw["kv_len"]
    qpos = kw["q_offset"] + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    mask = np.broadcast_to(kpos < kv_len, (Sq, Skv))
    if kw["causal"]:
        mask = mask & (kpos <= qpos)
    if kw["window"] is not None:
        mask = mask & (kpos > qpos - kw["window"])
    kk = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kk) / np.sqrt(D)
    s = jnp.where(mask, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1) * np.log2(np.e)), mask


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_statistic_matches_jax_logsumexp(case, dtype):
    """``flash_attention_ref(return_lse=True)`` gives the quantity both
    forward kernels write: JAX's log-sum-exp of the masked, scaled scores in
    log2 units, +inf (not JAX's -inf) for a row that sees no key; and
    exp2(scale_log2 q k^T - lse) on the visible keys is the forward's
    softmax, the rows summing to 1, which is how the backward kernel uses
    it."""
    q, k, v, _ = _inputs(case, dtype)
    kw = _kw(case)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.is_contiguous()
    assert lse.shape == q.shape[:3]
    torch.testing.assert_close(out, ref.flash_attention_ref(tq, tk, tv, **kw),
                               rtol=0, atol=0)
    # JAX on the same values (bf16 inputs widened exactly to float32)
    want, mask = _jax_lse(tq.float().numpy(), tk.float().numpy(), kw)
    seen = mask.any(axis=-1)
    got = lse.numpy()
    assert np.all(np.isposinf(got[:, :, ~seen]))
    assert np.all(np.isneginf(want[:, :, ~seen]))
    np.testing.assert_allclose(got[:, :, seen], want[:, :, seen],
                               rtol=LSE_TOL, atol=LSE_TOL)
    # P from the statistic, with the kernels' scale_log2
    B, Hq, Sq, D = q.shape
    g = Hq // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", tq.float(),
                     tk.float().repeat_interleave(g, dim=1))
    p = torch.exp2(s * (ref.LOG2E / D ** 0.5) - lse[..., None])
    p = p * torch.from_numpy(np.array(mask))
    rows = torch.from_numpy(np.array(seen))
    torch.testing.assert_close(p.sum(-1)[:, :, rows],
                               torch.ones(B, Hq, int(seen.sum())),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", TOL)
def test_function_hands_the_saved_statistic_to_the_backward(dtype,
                                                            monkeypatch):
    """``FlashAttention.forward`` asks the forward for the statistic, saves
    it and hands it to ``flash_attention_bwd``; the gradients still equal
    ``jax.vjp``'s."""
    case = "gqa+offset"
    q, k, v, dout = _inputs(case, dtype)
    kw = _kw(case)
    _, want = _jax_grads(q, k, v, dout, dtype, kw)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    handed = []
    real = ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        lambda *a, **k_: handed.append(a[4]) or real(*a,
                                                                     **k_))
    out = ops.FlashAttention.apply(*t, kw["causal"], kw["window"],
                                   kw["q_offset"], kw["kv_len"])
    out.backward(torch.from_numpy(dout).to(tdt))
    _, lse = ref.flash_attention_ref(*(x.detach() for x in t),
                                     return_lse=True, **kw)
    assert len(handed) == 1
    torch.testing.assert_close(handed[0], lse, rtol=0, atol=0)
    tol = TOL[dtype]
    for name, x, w in zip(("dq", "dk", "dv"), t, want):
        np.testing.assert_allclose(x.grad.float().numpy(), w, rtol=tol,
                                   atol=tol, err_msg=f"{dtype} {name}")


def test_bwd_wrapper_refuses_a_wrong_statistic():
    """The statistic must be the forward's: (B, Hq, Sq), float32,
    contiguous, on q's device. The backward's route is a function of D,
    the same in both input types."""
    q, k, v, dout = map(torch.from_numpy, _inputs("causal", "float32"))
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_bwd(q, k, v, out, lse[:, :, :-1], dout)
    with pytest.raises(TypeError, match="lse must be float32"):
        ops.flash_attention_bwd(q, k, v, out, lse.double(), dout)
    with pytest.raises(ValueError, match="lse is on"):
        ops.flash_attention_bwd(q, k, v, out, lse.to("meta"), dout)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_bwd(q, k, v, out, lse.mT.contiguous().mT, dout)
    assert [ops.bwd_route(D) for D in (8, 128, 136, 256)] == [
        "tensor cores", "tensor cores", "cuda cores", "cuda cores"]
    assert set(ops.BWD_ROUTES) == {"tensor cores", "cuda cores"}
