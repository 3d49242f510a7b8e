"""Kernel 8 of the port on the CPU: the plain version behind the
flash-attention wrapper against the JAX package's ``flash_attention_ref``
(and, on two shapes, against the Pallas kernel itself in interpret mode),
in float32 within 2e-5 and in bfloat16 within 2e-2, the tolerances of
``tests/test_kernels.py``; and the wrapper's choice between its two CUDA
kernels (``route``) and the tensor-map geometry it hands the tensor-core
kernel, both pure functions of the inputs' layout. The CUDA kernels are
held against this plain version by chip_smoke.py on the card."""

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


@pytest.mark.parametrize("dtype,D", [("float32", 16), ("bfloat16", 128)])
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(dtype, D):
    """On the CPU neither kernel runs, whichever route the inputs would take
    on the card: every route's counter stays 0."""
    (_, _, _), (q, k, v), _ = _inputs((2, 8, 2, 40, 72, D), dtype, 5)
    ops.reset_launches()
    for kw in (dict(causal=True), dict(causal=True, window=9, q_offset=32),
               dict(causal=False, kv_len=50)):
        got = ops.flash_attention(q, k, v, **kw)
        assert torch.equal(got, ref.flash_attention_ref(q, k, v, **kw))
        assert torch.equal(layers.chunked_attention(q, k, v, bq=8, bk=16,
                                                    gqa="repeat", **kw), got)
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_sm90": 0}


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


# ------------------------------------------------------------------ routing
def _layout(shape, dtype, layout, bits=False):
    """A (B, H, S, D) tensor of ``dtype`` laid out as ``layout`` says; with
    ``bits``, its elements are distinct bit patterns (compare them through
    ``.view(INT[dtype])``)."""
    B, H, S, D = shape

    def buf(m):
        if bits:
            return torch.arange(m, dtype=INT[dtype]).view(dtype)
        return torch.arange(m, dtype=torch.float32).to(dtype)

    n = B * H * S * D
    if layout == "contiguous":
        return buf(n).view(B, H, S, D)
    if layout == "movedim view":        # the model's (B, S, H, D) projection
        return buf(n).view(B, S, H, D).movedim(1, 2)
    if layout == "misaligned storage_offset":
        return buf(n + 1)[1:].view(B, H, S, D)
    if layout == "d stride 2":
        return buf(2 * n).view(B, H, S, 2 * D)[..., ::2]
    assert layout == "padded row"       # row stride D + 1: not 16-byte
    return buf(B * H * S * (D + 1)).view(B, H, S, D + 1)[..., :D]


INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
LAYOUTS = ["contiguous", "movedim view", "misaligned storage_offset",
           "d stride 2", "padded row"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("D", [64, 128, 16, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_is_a_function_of_dtype_head_size_and_layout(dtype, D, layout):
    """bf16 with D in {64, 128} and TMA-legal layouts (d stride 1, other
    strides multiples of 16 bytes, 16-byte aligned data) go to the
    tensor-core kernel; everything else to the CUDA-core kernel."""
    q = _layout((2, 8, 24, D), dtype, layout)
    k = _layout((2, 2, 40, D), dtype, layout)
    v = _layout((2, 2, 40, D), dtype, layout)
    legal = layout in ("contiguous", "movedim view")
    want = ops.SM90 if dtype == torch.bfloat16 and D in (64, 128) and legal \
        else ops.CUDA_CORES
    assert ops.route(q, k, v) == want
    if layout == "misaligned storage_offset":
        assert q.data_ptr() % 16 != 0
    # the route decides nothing about the result: on the CPU both are the
    # plain version
    got = ops.flash_attention(q, k, v)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("odd", ["q", "k", "v"])
def test_route_needs_all_three_tensors_tma_legal(odd):
    """One tensor that a tensor map cannot describe sends the call to the
    CUDA-core kernel."""
    shapes = {"q": (1, 4, 16, 128), "k": (1, 2, 16, 128),
              "v": (1, 2, 16, 128)}
    ts = {n: _layout(sh, torch.bfloat16, "padded row" if n == odd else
                     "contiguous") for n, sh in shapes.items()}
    assert ops.route(ts["q"], ts["k"], ts["v"]) == ops.CUDA_CORES
    ts[odd] = _layout(shapes[odd], torch.bfloat16, "movedim view")
    assert ops.route(ts["q"], ts["k"], ts["v"]) == ops.SM90


@pytest.mark.parametrize("layout", ["contiguous", "movedim view",
                                    "padded row", "misaligned storage_offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tma_geometry_rebuilds_the_tensor(dtype, layout):
    """The tensor map's dims (D, S, H, B), innermost first, and its byte
    strides of S, H and B, read back through ``torch.as_strided`` on the
    same storage, give the same elements."""
    t = _layout((2, 3, 5, 64), dtype, layout, bits=True)
    D, S, H, B, ss, hs, bs = ops.tma_geometry(t)
    assert (B, H, S, D) == tuple(t.shape)
    e = t.element_size()
    assert all(x % e == 0 for x in (ss, hs, bs))
    rebuilt = torch.as_strided(t, (B, H, S, D), (bs // e, hs // e, ss // e, 1),
                               t.storage_offset())
    assert torch.equal(rebuilt.view(INT[dtype]), t.view(INT[dtype]))
    assert ops.tma_legal(t) == (layout in ("contiguous", "movedim view"))
    if ops.tma_legal(t):
        assert all(x % ops.TMA_ALIGN == 0 for x in (ss, hs, bs))
