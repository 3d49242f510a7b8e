"""Kernel 8 of the port on the CPU: the plain version behind the
flash-attention wrapper against the JAX package's ``flash_attention_ref``
(and, on two shapes, against the Pallas kernel itself in interpret mode),
in float32 within 2e-5 and in bfloat16 within 2e-2, the tolerances of
``tests/test_kernels.py``. The CUDA kernel is held against this plain
version by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro.models.layers import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: tests/test_kernels.py's sweep: B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset
SWEEP = [
    (1, 4, 4, 128, 128, 64, True, None, 0),
    (2, 8, 2, 128, 256, 64, True, None, 128),      # GQA + decode offset
    (1, 4, 1, 256, 256, 128, True, 64, 0),         # sliding window
    (1, 2, 2, 128, 384, 64, False, None, 0),       # cross-attention style
    (2, 4, 4, 8, 128, 64, True, None, 120),        # short q against a cache
]
#: the cases the sweep leaves out, kv_len last
EXTRA = {
    "ragged": (1, 4, 2, 100, 200, 16, True, None, 100, None),
    "group8-kv_len": (2, 8, 1, 48, 160, 32, True, None, 112, 131),
    "window-3-tiles": (1, 2, 1, 300, 300, 16, True, 150, 0, None),
    "no-visible-key": (1, 4, 2, 8, 8, 16, True, 2, 20, None),
}


def _inputs(shape, dtype, seed):
    B, Hq, Hkv, Sq, Skv, D = shape
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, Hq, Sq, D), rng.randn(B, Hkv, Skv, D),
            rng.randn(B, Hkv, Skv, D)]
    jdt, tdt, tol = DTYPES[dtype]
    j = [jnp.asarray(a.astype(np.float32), jdt) for a in arrs]
    t = [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs]
    return j, t, tol


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window,qoff", SWEEP)
def test_plain_matches_jax_ref_sweep(B, Hq, Hkv, Sq, Skv, D, causal, window,
                                     qoff, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs((B, Hq, Hkv, Sq, Skv, D), dtype,
                                           Sq + Skv)
    want = j_ref(jq, jk, jv, causal=causal, window=window, q_offset=qoff)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=qoff)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", EXTRA)
def test_plain_matches_jax_ref_edges(case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, window, qoff, kv_len = EXTRA[case]
    (jq, jk, jv), (q, k, v), tol = _inputs((B, Hq, Hkv, Sq, Skv, D), dtype, 3)
    kw = dict(causal=causal, window=window, q_offset=qoff, kv_len=kv_len)
    want = j_ref(jq, jk, jv, **kw)
    got = ref.flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_no_visible_key_is_mean_of_v():
    """Window 2 at q_offset 20 over 8 keys: no query sees a key, and the
    plain version gives the mean of v over all Skv keys, as the JAX
    reference does (and as the LM path's chunked attention does when Skv is
    one block) - not zero, and not the Pallas kernel's mean over its padded
    block."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, qoff, _ = EXTRA["no-visible-key"]
    (jq, jk, jv), (q, k, v), _ = _inputs((B, Hq, Hkv, Sq, Skv, D),
                                         "float32", 3)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=qoff)
    mean = v.mean(dim=2, keepdim=True).repeat_interleave(Hq // Hkv, dim=1)
    np.testing.assert_allclose(got.numpy(), mean.expand_as(got).numpy(),
                               rtol=2e-5, atol=2e-5)
    chunked = j_chunked(jq, jk, jv, causal=causal, window=window,
                        q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), _np(chunked), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape,causal,window,qoff", [
    ((1, 4, 2, 64, 128, 32), True, None, 64),
    ((1, 2, 1, 128, 128, 16), True, 40, 0),
])
def test_plain_matches_pallas_interpret(shape, causal, window, qoff):
    """The Pallas kernel itself (interpret mode on the CPU), on shapes where
    every query sees a key."""
    (jq, jk, jv), (q, k, v), tol = _inputs(shape, "float32", 11)
    want = j_flash(jq, jk, jv, causal=causal, window=window, q_offset=qoff)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=qoff)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    (_, _, _), (q, k, v), _ = _inputs((2, 8, 2, 40, 72, 16), "float32", 5)
    ops.reset_launches()
    for kw in (dict(causal=True), dict(causal=True, window=9, q_offset=32),
               dict(causal=False, kv_len=50)):
        got = ops.flash_attention(q, k, v, **kw)
        assert torch.equal(got, ref.flash_attention_ref(q, k, v, **kw))
        assert torch.equal(layers.chunked_attention(q, k, v, bq=8, bk=16,
                                                    gqa="repeat", **kw), got)
    assert ops.LAUNCHES == {"flash_attention": 0}


def test_wrapper_reads_movedim_views():
    """The model hands (B, S, H, D) projections over as (B, H, S, D) views."""
    rng = np.random.RandomState(2)
    q4 = torch.from_numpy(rng.randn(2, 24, 4, 16).astype(np.float32))
    k4 = torch.from_numpy(rng.randn(2, 24, 2, 16).astype(np.float32))
    got = ops.flash_attention(q4.movedim(1, 2), k4.movedim(1, 2),
                              k4.movedim(1, 2))
    want = ops.flash_attention(q4.movedim(1, 2).contiguous(),
                               k4.movedim(1, 2).contiguous(),
                               k4.movedim(1, 2).contiguous())
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad,err", [
    (dict(k=torch.zeros(1, 3, 8, 16)), ValueError),      # Hkv does not divide Hq
    (dict(v=torch.zeros(1, 2, 9, 16)), ValueError),      # k and v differ
    (dict(q=torch.zeros(1, 4, 8, 16, dtype=torch.float16)), TypeError),
    (dict(k=torch.zeros(1, 2, 0, 16), v=torch.zeros(1, 2, 0, 16)), ValueError),
    (dict(window=0), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    args = dict(q=torch.zeros(1, 4, 8, 16), k=torch.zeros(1, 2, 8, 16),
                v=torch.zeros(1, 2, 8, 16))
    window = bad.pop("window", None)
    args.update(bad)
    with pytest.raises(err):
        ops.flash_attention(args["q"], args["k"], args["v"], window=window)
