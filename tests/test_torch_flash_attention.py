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
    assert ops.LAUNCHES == {"flash_attention": 0,
                            "flash_attention_sm90": 0,
                            "flash_attention_bwd": 0}


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
    tensor-core kernel; everything else to the split-TF32 kernel."""
    q = _layout((2, 8, 24, D), dtype, layout)
    k = _layout((2, 2, 40, D), dtype, layout)
    v = _layout((2, 2, 40, D), dtype, layout)
    legal = layout in ("contiguous", "movedim view")
    want = ops.SM90 if dtype == torch.bfloat16 and D in (64, 128) and legal \
        else ops.SPLIT_TF32
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
    split-TF32 kernel."""
    shapes = {"q": (1, 4, 16, 128), "k": (1, 2, 16, 128),
              "v": (1, 2, 16, 128)}
    ts = {n: _layout(sh, torch.bfloat16, "padded row" if n == odd else
                     "contiguous") for n, sh in shapes.items()}
    assert ops.route(ts["q"], ts["k"], ts["v"]) == ops.SPLIT_TF32
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


# ------------------------------------------- the split-TF32 kernel's arithmetic
#: the sweep's shapes at each head size the split-TF32 kernel builds tiles
#: for, and the edge cases, as (B, Hq, Hkv, Sq, Skv, D, causal, window,
#: q_offset, kv_len)
SPLIT_CASES = {
    **{f"sweep-{i}-D{D}": (*shape[:5], D, *shape[6:], None)
       for i, shape in enumerate(SWEEP) for D in (16, 64, 128, 256)},
    **EXTRA,
}


def _tf32_model(q, k, v, *, causal=True, window=None, q_offset=0,
                kv_len=None, split=True):
    """Attention as ``csrc/flash_attention.cu`` computes it, on the CPU:
    each operand of both products split as ``ref.split_tf32`` splits it
    (with ``split=False``, rounded once to TF32 instead), products of TF32
    values taken exactly (11-bit significands: exact in float32) and summed
    in float32, the small terms first. The scores are scaled after the
    product; P is the unnormalised exp(s - max), split too, and O is divided
    by the row sum at the end."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]

    def product(eq, a, b):
        if not split:
            return torch.einsum(eq, ref.tf32_round(a), ref.tf32_round(b))
        ah, al = ref.split_tf32(a)
        bh, bl = ref.split_tf32(b)
        small = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
        return small + torch.einsum(eq, ah, bh)

    qg = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = product("bhgqd,bhkd->bhgqk", qg, k.float()) / D ** 0.5
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = kpos < (Skv if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = s.masked_fill(~mask, ref.NEG_INF)
    p = (s - s.amax(dim=-1, keepdim=True)).exp()
    lsum = p.sum(dim=-1, keepdim=True)
    out = product("bhgqk,bhkd->bhgqd", p, v.float())
    out = out / torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the rows (b, h, i)."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_tf32_model_holds_float32_tolerance(case):
    """Split TF32, the kernel's arithmetic for float32, is within float32's
    2e-5 of both plain versions (the port's and JAX's), with every row's
    relative error norm within chip_smoke.py's 1e-5."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, qoff, kv_len = SPLIT_CASES[case]
    (jq, jk, jv), (q, k, v), tol = _inputs((B, Hq, Hkv, Sq, Skv, D),
                                           "float32", Sq + Skv + D)
    kw = dict(causal=causal, window=window, q_offset=qoff, kv_len=kv_len)
    got = _tf32_model(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)
    assert _row_rel_err(got, want) <= 1e-5
    np.testing.assert_allclose(got.numpy(), _np(j_ref(jq, jk, jv, **kw)),
                               rtol=tol, atol=tol)


def test_single_tf32_misses_float32_tolerance():
    """Why the kernel splits: one TF32 product per multiply-add (10 stored
    mantissa bits) misses float32's 2e-5 on the sweep's window case at D
    128, where split TF32 holds it."""
    shape = (*SWEEP[2][:5], 128)
    (_, _, _), (q, k, v), tol = _inputs(shape, "float32", 7)
    kw = dict(causal=SWEEP[2][6], window=SWEEP[2][7], q_offset=SWEEP[2][8])
    want = ref.flash_attention_ref(q, k, v, **kw)
    single = _tf32_model(q, k, v, split=False, **kw)
    err = float((single - want).abs().max())
    assert err > 10 * tol
    assert not torch.allclose(single, want, rtol=tol, atol=tol)
    split = _tf32_model(q, k, v, **kw)
    assert torch.allclose(split, want, rtol=tol, atol=tol)


def test_split_tf32_of_bfloat16_values_has_no_lo():
    """Every finite bfloat16 value is exact in TF32: its hi is itself and
    its lo is 0, so the kernel's bf16 route skips the products of lo."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    hi, lo = ref.split_tf32(x)
    assert x.numel() == 2 ** 16 - 2 * 2 ** 7   # all but the two infs and NaNs
    assert torch.equal(hi, x)
    assert torch.equal(lo, torch.zeros_like(x))


def test_tf32_round_is_to_nearest_ties_away_from_zero():
    """``tf32_round`` keeps 10 stored mantissa bits, rounds to the nearest
    such value, and a tie away from zero, as ``cvt.rna.tf32.f32`` does; the
    split hi + lo then carries x to within 2^-22 of |x|."""
    one = 1.0
    ties = torch.tensor([one + 2 ** -11, -(one + 2 ** -11),
                         one + 2 ** -10 + 2 ** -11, 2.0 + 2 ** -10])
    assert ref.tf32_round(ties).tolist() == [
        one + 2 ** -10, -(one + 2 ** -10), one + 2 ** -9, 2.0 + 2 ** -9]
    x = torch.from_numpy(np.random.RandomState(3).randn(10_000)
                         .astype(np.float32)) * 1e3
    hi, lo = ref.split_tf32(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)
    assert torch.all((x - hi).abs() <= ulp / 2)
    assert torch.all((x - hi - lo).abs() <= x.abs() * 2.0 ** -22)
