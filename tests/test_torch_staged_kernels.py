"""The staged accelerator path of the port against the JAX package on the CPU,
bit for bit: the plain versions behind the wrappers of kernels 3-7
(``fused_event_lif``, ``spike_matmul``, ``lif_fused``, ``ttfs_decode``,
``event_accum``) against the JAX ops running their Pallas kernels in
interpret mode, and ``kernel="cuda"`` end to end against the JAX
``kernel="pallas"`` accelerator. The CUDA kernels themselves are held
against these plain versions by chip_smoke.py on the card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codesign as jcodesign
from repro.core import events as jevents
from repro.core import lif_dynamics as jlif
from repro.core import quant as jquant
from repro.core import ttfs as jttfs
from repro.core.accelerator import SNNAccelerator as JAccelerator
from repro.core.artifact import FORMAT_VERSION
from repro.core.artifact import Artifact as JArtifact
from repro.core.reference import SNNReference as JReference
from repro.kernels.event_accum.ops import event_accum as j_event_accum
from repro.kernels.fused_event_lif import ops as jfused
from repro.kernels.lif.ops import lif_fused as j_lif_fused
from repro.kernels.spike_matmul.ops import spike_matmul as j_spike_matmul
from repro.kernels.ttfs_decode.ops import ttfs_decode as j_ttfs_decode
from repro.serving.snn_engine import SNNServeEngine as JEngine
from repro_torch.core import events, lif_dynamics
from repro_torch.core.accelerator import SNNAccelerator
from repro_torch.core.artifact import Artifact, from_numpy
from repro_torch.core.reference import SNNReference
from repro_torch.data import mnist
from repro_torch.kernels.event_accum import ops as ea_ops
from repro_torch.kernels.fused_event_lif import ops as fused_ops
from repro_torch.kernels.lif import ops as lif_ops
from repro_torch.kernels.spike_matmul import ops as smm_ops
from repro_torch.kernels.ttfs_decode import ops as dec_ops
from repro_torch.serving.scheduler import ServingScheduler
from repro_torch.serving.snn_engine import SNNServeEngine

MNIST_ART = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                         "assets", "mnist_ttfs.npz")
KEYS = ("labels", "first_spike", "v_final", "steps")
OPS = (ea_ops, fused_ops, lif_ops, smm_ops, dec_ops)


@pytest.fixture(scope="module")
def mnist64():
    x, _ = mnist.generate(64, 1235)         # the first 64 test images
    return x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ kernel 7
@pytest.mark.parametrize("T,E,K,N", [(4, 16, 100, 128), (8, 64, 784, 256),
                                     (3, 128, 129, 128)])
def test_event_accum_matches_jax(T, E, K, N):
    rng = np.random.RandomState(T * E + K)
    ids = rng.randint(-1, K, (T, E)).astype(np.int32)
    ids[:, E // 2] = -1                      # PAD in the middle of every row
    ids[-1] = -1                             # an all-PAD step
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    want = np.asarray(j_event_accum(jnp.asarray(ids), jnp.asarray(w)))
    got = ea_ops.event_accum(_t(ids), _t(w))
    assert got.dtype == torch.int32 and got.shape == (T, N)
    assert np.array_equal(got.numpy(), want)
    # the served form: (B, T, E) in one call, each row as JAX computes it
    batch = np.stack([ids, np.roll(ids, 5, axis=1), ids[::-1]])
    got = ea_ops.event_accum(_t(batch), _t(w))
    for b in range(3):
        assert np.array_equal(got[b].numpy(), np.asarray(j_event_accum(
            jnp.asarray(batch[b]), jnp.asarray(w))))
    assert ea_ops.event_accum(_t(batch[:0]), _t(w)).shape == (0, T, N)


def test_event_accum_takes_any_e_max():
    """E_max 16,384, past the 12,000 slots the first CUDA kernel staged in
    shared memory: two steps of ids with PAD in the middle of each row and a
    run of ids at or past N_in, against JAX's Pallas kernel."""
    T, E, K, N = 2, 16_384, 300, 128
    rng = np.random.RandomState(E)
    ids = rng.randint(0, K, (T, E)).astype(np.int32)
    ids[:, E // 3:E // 3 + 4000] = -1        # PAD mid-row
    ids[1, ::7] = -1
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    want = np.asarray(j_event_accum(jnp.asarray(ids), jnp.asarray(w)))
    got = ea_ops.event_accum(_t(ids), _t(w))
    assert np.array_equal(got.numpy(), want)
    exact = np.zeros((T, N), np.int64)
    for t in range(T):
        live = ids[t][ids[t] >= 0]
        exact[t] = w[live].astype(np.int64).sum(axis=0)
    assert np.array_equal(got.numpy(), exact)
    # ids at or past N_in add nothing (JAX's kernel reads no such id)
    far = ids.copy()
    far[:, E // 3:E // 3 + 4000] = K + 5
    assert torch.equal(ea_ops.event_accum(_t(far), _t(w)), got)


# ------------------------------------------------------------ kernel 5
@pytest.mark.parametrize("B,T,N,ls", [(3, 16, 256, 2), (5, 7, 128, 31),
                                      (0, 4, 128, 4)])
def test_lif_fused_matches_jax_on_a_movedim_view(B, T, N, ls):
    rng = np.random.RandomState(B * 100 + T)
    # (B, T, N) as the staged pipeline writes it; mostly negative drive
    cur = rng.randint(-300, 150, (B, T, N)).astype(np.int32)
    thr = rng.randint(10, 500, (N,)).astype(np.int32)
    view = _t(cur).movedim(1, 0)             # (T, B, N), not contiguous
    res = lif_ops.lif_fused(view, _t(thr), ls)
    assert res.first_spike.shape == (B, N)
    if B:
        assert not view.is_contiguous()
        jres = j_lif_fused(jnp.moveaxis(jnp.asarray(cur), 1, 0),
                           jnp.asarray(thr), ls)
        assert np.array_equal(res.first_spike.numpy(),
                              np.asarray(jres.first_spike))
        assert np.array_equal(res.v_final.numpy(), np.asarray(jres.v_final))
        assert (res.v_final < 0).any()
        assert (res.first_spike < T).any()


def _lif_layouts(B, T, N, rng):
    """(B, T, N) currents as the staged path's movedim view and in two
    layouts a caller may hand over: {name: (T, B, N) view}."""
    cur = rng.randint(-300, 400, (B, T, N)).astype(np.int32)
    base = torch.from_numpy(cur)
    wide = torch.zeros((B, T, 2 * N), dtype=torch.int32)
    wide[..., ::2] = base
    flat = torch.zeros((B * T * N + 1,), dtype=torch.int32)
    flat[1:] = base.reshape(-1)
    return cur, {"movedim": base.movedim(1, 0),
                 "lane stride 2": wide[..., ::2].movedim(1, 0),
                 "odd offset": flat[1:].view(B, T, N).movedim(1, 0)}


@pytest.mark.parametrize("B,T,N,layout", [
    (3, 33, 256, "movedim"),          # a chunk of 32 steps and one step
    (2, 100, 128, "movedim"),         # three chunks and four single steps
    (3, 31, 256, "movedim"),          # no chunk: 31 single steps
    (3, 33, 256, "lane stride 2"),
    (2, 40, 128, "odd offset")])      # a chunk and eight single steps
def test_lif_fused_matches_jax_on_long_windows_and_layouts(B, T, N, layout):
    """Windows the CUDA kernel splits into chunks of 32 steps and a tail it
    scans step by step, and layouts other than the staged path's, against
    JAX's Pallas kernel (interpret mode), bit for bit."""
    rng = np.random.RandomState(T * N + B)
    cur, views = _lif_layouts(B, T, N, rng)
    thr = rng.randint(300, 2000, (N,)).astype(np.int32)
    res = lif_ops.lif_fused(views[layout], _t(thr), 3)
    jres = j_lif_fused(jnp.moveaxis(jnp.asarray(cur), 1, 0),
                       jnp.asarray(thr), 3)
    assert np.array_equal(res.first_spike.numpy(),
                          np.asarray(jres.first_spike))
    assert np.array_equal(res.v_final.numpy(), np.asarray(jres.v_final))
    fired = res.first_spike.numpy()
    assert (fired == T).any()
    assert ((fired > T // 2) & (fired < T)).any()       # late spikes too


def test_early_exit_rows_matches_jax_vmap():
    rng = np.random.RandomState(11)
    T, B, N = 12, 9, 40
    cur = rng.randint(-400, 250, (T, B, N)).astype(np.int32)
    cur[:, 0] = -5                           # a row that never fires
    thr = rng.randint(50, 900, (N,)).astype(np.int32)
    for ls in (2, 31):
        res, steps = lif_dynamics.lif_scan_early_exit_rows(
            _t(cur), _t(thr), ls, T)
        jres, jsteps = jax.vmap(
            lambda c: jlif.lif_scan_early_exit(c, jnp.asarray(thr), ls, T),
            in_axes=1)(jnp.asarray(cur))
        assert np.array_equal(steps.numpy(), np.asarray(jsteps))
        assert np.array_equal(res.first_spike.numpy(),
                              np.asarray(jres.first_spike))
        assert np.array_equal(res.v_final.numpy(), np.asarray(jres.v_final))
        assert steps[0] == T and (steps < T).any()


# ------------------------------------------------------------ kernel 6
@pytest.mark.parametrize("fallback", ["membrane", "zero"])
def test_ttfs_decode_matches_jax_on_ties_and_strided_rows(fallback):
    rng = np.random.RandomState(5)
    G, P, T, B, n_pad = 6, 5, 4, 40, 48
    first = rng.choice([1, 2, T], size=(B, n_pad)).astype(np.int32)
    first[:12] = T                           # no spike: the fallback decides
    v = rng.randint(-3, 3, (B, n_pad)).astype(np.int32)      # tie-heavy
    n = G * P
    got = dec_ops.ttfs_decode(_t(first)[:, :n], _t(v)[:, :n], n_groups=G,
                              per_group=P, sentinel=T, fallback=fallback)
    want = j_ttfs_decode(jnp.asarray(first[:, :n]), jnp.asarray(v[:, :n]),
                         n_groups=G, per_group=P, sentinel=T,
                         fallback=fallback)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert len(set(got[:12].tolist())) > 1 or fallback == "zero"
    empty = dec_ops.ttfs_decode(_t(first)[:0, :n], _t(v)[:0, :n], n_groups=G,
                                per_group=P, sentinel=T, fallback=fallback)
    assert empty.shape == (0,)


@pytest.mark.parametrize("fallback", ["membrane", "zero"])
def test_ttfs_decode_matches_jax_on_negative_first(fallback):
    """Negative first-spike times (the packed key first*n + lane is then
    negative: the pair rule needs no floor-mod), against JAX's kernel."""
    rng = np.random.RandomState(17)
    G, P, T, B = 10, 15, 32, 24
    n = G * P
    first = rng.choice([-7, -1, 0, 3, T], size=(B, n)).astype(np.int32)
    first[:6] = T                            # no spike: the fallback decides
    first[6:9] = rng.choice([-1, T], size=(3, n))
    v = rng.randint(-3, 3, (B, n)).astype(np.int32)
    got = dec_ops.ttfs_decode(_t(first), _t(v), n_groups=G, per_group=P,
                              sentinel=T, fallback=fallback)
    want = j_ttfs_decode(jnp.asarray(first), jnp.asarray(v), n_groups=G,
                         per_group=P, sentinel=T, fallback=fallback)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert len(set(got[6:].tolist())) > 1


@pytest.mark.parametrize("fallback", ["membrane", "zero"])
@pytest.mark.parametrize("G,P,route", [(7, 9, "warp"), (32, 32, "warp"),
                                       (25, 41, "block"), (16, 128, "block")])
def test_ttfs_decode_matches_jax_on_ties_across_lanes_and_the_cut(
        G, P, route, fallback):
    """Rows whose winners tie between lanes a warp folds in different warp
    lanes (or, on the block route, in different warps), n not a multiple of
    32 (63, 1025), and n on both sides of the warp/block cut (1024, 1025,
    2048), against JAX's kernel."""
    n, T, B = G * P, 16, 10
    assert dec_ops.route(n) == route
    rng = np.random.RandomState(n)
    first = np.full((B, n), T, np.int32)
    v = np.zeros((B, n), np.int32)
    a, b = 3, n - 2                          # warp lanes 3 and (n - 2) % 32
    first[0, [a, b]] = 5                     # a tie: the lower lane wins
    first[1, [b, n - 1]] = 4
    first[2] = rng.choice([2, 3, T], size=n)  # many ties at 2
    first[3, n - 1] = 0                      # the last lane alone
    v[4, [a, b]] = 9                         # no spike: tied membranes
    v[5, [b, n - 1]] = 9
    v[6] = rng.randint(-2, 2, n)             # tie-heavy membranes
    v[7] = np.iinfo(np.int32).min            # every membrane at INT32_MIN
    v[8, n - 1] = 1
    first[9] = rng.choice([1, T], size=n)
    got = dec_ops.ttfs_decode(_t(first), _t(v), n_groups=G, per_group=P,
                              sentinel=T, fallback=fallback)
    want = np.asarray(j_ttfs_decode(jnp.asarray(first), jnp.asarray(v),
                                    n_groups=G, per_group=P, sentinel=T,
                                    fallback=fallback))
    assert np.array_equal(got.numpy(), want)
    assert want[0] == a // P and want[1] == b // P and want[3] == G - 1
    if fallback == "membrane":
        assert want[4] == a // P and want[5] == b // P
        assert want[7] == 0 and want[8] == G - 1


# ------------------------------------------------------------ kernel 4
@pytest.mark.parametrize("B,T,K,N", [(4, 3, 129, 128), (2, 8, 784, 256),
                                     (1, 5, 300, 200), (0, 4, 129, 128)])
def test_spike_matmul_matches_jax_on_ragged_shapes(B, T, K, N):
    rng = np.random.RandomState(K + N)
    raster = rng.randint(-128, 128, (B, T, K)).astype(np.int8)   # any int8
    w = rng.randint(-128, 128, (K, N)).astype(np.int8)
    got = smm_ops.spike_matmul(_t(raster), _t(w))
    assert got.dtype == torch.int32 and got.shape == (B, T, N)
    if B:
        want = np.asarray(j_spike_matmul(jnp.asarray(raster), jnp.asarray(w)))
        assert np.array_equal(got.numpy(), want)
        exact = raster.astype(np.int64) @ w.astype(np.int64)
        assert np.array_equal(got.numpy(), exact)


def test_spike_matmul_takes_any_k():
    """K 140,000, past the first kernel's 131,072: a {0,1} raster against
    JAX, and an int8 product that overflows int32, which wraps as int32
    accumulation does (numpy's int64 sum modulo 2**32)."""
    K, N = 140_000, 8
    rng = np.random.RandomState(K)
    raster = rng.randint(0, 2, (2, 3, K)).astype(np.int8)
    w = rng.randint(-128, 128, (K, N)).astype(np.int8)
    got = smm_ops.spike_matmul(_t(raster), _t(w))
    want = np.asarray(j_spike_matmul(jnp.asarray(raster), jnp.asarray(w)))
    assert np.array_equal(got.numpy(), want)
    big = np.full((4, K), -128, np.int8)
    big[1] = 127
    big[2] = rng.randint(-128, 128, K)
    wb = np.full((K, N), -128, np.int8)
    wb[:, 1] = 127
    exact = big.astype(np.int64) @ wb.astype(np.int64)
    assert (np.abs(exact) >= 2 ** 31).any()
    wrapped = ((exact + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    assert np.array_equal(smm_ops.spike_matmul(_t(big), _t(wb)).numpy(),
                          wrapped)
    w_t = smm_ops.k_major(_t(wb))
    assert w_t.shape == (N, K) and w_t.is_contiguous()
    assert np.array_equal(smm_ops.spike_matmul(_t(big), _t(wb),
                                               w_t=w_t).numpy(), wrapped)
    with pytest.raises(ValueError, match="w_t"):
        smm_ops.spike_matmul(_t(big), _t(wb), w_t=_t(wb))


# ------------------------------------------------------------ kernel 3
@pytest.mark.parametrize("B,T,n_in,N,ls", [(3, 8, 50, 128, 31),
                                           (2, 10, 100, 256, 3)])
def test_fused_event_lif_matches_jax_and_the_decode_kernel(B, T, n_in, N, ls):
    rng = np.random.RandomState(B + T)
    times = rng.randint(0, T + 1, (B, n_in)).astype(np.int32)
    times[0] = T                                        # an all-PAD row
    e_max = jevents.calibrate_e_max(times, T, lane=8)
    w = (rng.randint(-127, 128, (n_in, N)) - 20 * (ls == 31)).clip(
        -127, 127).astype(np.int8)
    thr = rng.randint(20, 1500, (N,)).astype(np.int32)
    jf = jevents.pack_events_batched(times, T, e_max)
    tf = events.pack_events_batched(times, T, e_max, device="cpu")
    res = fused_ops.fused_event_lif(tf.ids, tf.count, _t(w), _t(thr), ls)
    jres = jfused.fused_event_lif(jf.ids, jf.count, jnp.asarray(w),
                                  jnp.asarray(thr), ls, backend="pallas")
    assert np.array_equal(res.first_spike.numpy(),
                          np.asarray(jres.first_spike))
    assert np.array_equal(res.v_final.numpy(), np.asarray(jres.v_final))
    dec, _ = fused_ops.fused_event_lif_decode(
        tf.ids, tf.count, _t(w), _t(thr), ls, n_out=N, n_groups=N // 16,
        per_group=16)
    assert torch.equal(dec.first_spike, res.first_spike)
    assert torch.equal(dec.v_final, res.v_final)
    # the staged pipeline gives the same state
    cur = ea_ops.event_accum(tf.ids, _t(w))
    staged = lif_ops.lif_fused(cur.movedim(1, 0), _t(thr), ls)
    assert torch.equal(staged.first_spike, res.first_spike)
    assert torch.equal(staged.v_final, res.v_final)


def _wide_input_artifact(n_in: int, n_groups: int, per_group: int, T: int,
                        seed: int) -> JArtifact:
    """A valid linear-TTFS artifact with ``n_in`` inputs, built as the JAX
    package's conformance fuzzer builds one."""
    rng = np.random.RandomState(seed)
    n_out = n_groups * per_group
    w_int8, scale = jquant.quantize_weights(
        rng.randn(n_in, n_out).astype(np.float32))
    thr = rng.randint(2_000, 20_000, n_out).astype(np.int32)
    plan = jcodesign.plan(n_in, n_out)
    layout = jcodesign.blocked_layout(
        w_int8, thr, jttfs.group_map(n_groups, per_group), plan.lane)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": {"topology": "linear-ttfs", "n_in": n_in, "n_out": n_out},
        "encode": {"T": T, "x_min": 1.0 / 255.0},
        "lif": {"leak_shift": 4, "v_init": 0},
        "readout": {"n_groups": n_groups, "per_group": per_group,
                    "fallback": "membrane"},
        "quant": {"scale": scale, "bits": 8,
                  "scheme": "symmetric-per-tensor"},
        "events": {"e_max": n_in, "pad": jevents.PAD},
        "codesign": {"lane": plan.lane, "n_pad": plan.n_pad,
                     "n_blocks": plan.n_blocks, "vmem_util": plan.vmem_util,
                     "limiter": plan.limiter},
    }
    arrays = {"w_float": w_int8.astype(np.float32) * scale,
              "w_int8": w_int8, "thresholds": thr,
              "group_ids": jttfs.group_map(n_groups, per_group), **layout}
    return JArtifact(meta, arrays)


def test_reference_and_batch_torch_take_any_n_in():
    """n_in 140,000, past the 132,103 inputs at which one float32 product
    stops being exact: the plain product runs in exact slices over K, and
    the reference and the batch accelerator equal JAX's int32 products."""
    jart = _wide_input_artifact(140_000, 10, 12, T=4, seed=5)
    art = from_numpy(jart.meta, jart.arrays)
    assert art.fingerprint() == jart.fingerprint()
    assert art["w_padded"].shape == (140_000, 128)
    images = np.random.RandomState(6).rand(2, 140_000).astype(np.float32)
    want = JReference(jart).forward(images)
    got = SNNReference(art, device="cpu").forward(images)
    got_b = SNNAccelerator(art, mode="batch", kernel="torch",
                           device="cpu").forward(images)
    want_b = JAccelerator(jart, mode="batch", kernel="jnp").forward(images)
    for key in KEYS:
        assert np.array_equal(getattr(got, key).numpy(),
                              np.asarray(getattr(want, key))), key
        assert np.array_equal(getattr(got_b, key).numpy(),
                              np.asarray(getattr(want_b, key))), key
    assert (np.asarray(want.first_spike) < 4).any()       # lanes fire


# ------------------------------------------------------------ wrappers
def test_wrappers_on_cpu_count_no_launch_and_reject_bad_input():
    for ops in OPS:
        ops.reset_launches()
    w = torch.zeros((10, 128), dtype=torch.int8)
    ids = torch.full((2, 3, 4), -1, dtype=torch.int32)
    assert not ea_ops.event_accum(ids, w).any()
    cur = torch.zeros((3, 2, 128), dtype=torch.int32)
    thr = torch.ones((128,), dtype=torch.int32)
    lif_ops.lif_fused(cur, thr, 3)
    smm_ops.spike_matmul(torch.ones((2, 3, 10), dtype=torch.int8), w)
    dec_ops.ttfs_decode(cur[0, :, :12], cur[0, :, :12], n_groups=3,
                        per_group=4, sentinel=3)
    assert all(n == 0 for ops in OPS for n in ops.LAUNCHES.values())
    assert all(n == 0 for ops in OPS for n in getattr(ops, "ROUTES",
                                                      {}).values())
    with pytest.raises(TypeError, match="int8"):
        ea_ops.event_accum(ids, w.int())
    with pytest.raises(ValueError, match="ids"):
        ea_ops.event_accum(ids[..., :0], w)
    with pytest.raises(ValueError, match="leak_shift"):
        lif_ops.lif_fused(cur, thr, 32)
    with pytest.raises(ValueError, match="thresholds"):
        lif_ops.lif_fused(cur, thr[:64], 3)
    with pytest.raises(ValueError, match="raster"):
        smm_ops.spike_matmul(torch.ones((2, 11), dtype=torch.int8), w)
    with pytest.raises(ValueError, match="n_groups"):
        dec_ops.ttfs_decode(cur[0, :, :12], cur[0, :, :12], n_groups=5,
                            per_group=4, sentinel=3)
    with pytest.raises(ValueError, match="fallback"):
        dec_ops.ttfs_decode(cur[0, :, :12], cur[0, :, :12], n_groups=3,
                            per_group=4, sentinel=3, fallback="max")


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("mode", ["event", "batch"])
def test_cuda_accelerator_matches_jax_pallas(mnist64, mode):
    got = SNNAccelerator(Artifact.load(MNIST_ART), mode=mode, kernel="cuda",
                         device="cpu").forward(mnist64)
    want = JAccelerator(JArtifact.load(MNIST_ART), mode=mode,
                        kernel="pallas").forward(mnist64)
    for key in KEYS:
        assert np.array_equal(getattr(got, key).numpy(),
                              np.asarray(getattr(want, key))), key
    ref = SNNReference(Artifact.load(MNIST_ART), device="cpu").forward(mnist64)
    assert torch.equal(got.labels, ref.labels)


def test_cuda_latency_mode_matches_jax(mnist64):
    """JAX's ``kernel="pallas"`` latency path does not run (its decode kernel
    is handed the 1-D rows of its vmap), so the staged early exit is held to
    JAX's ``jnp`` staged path, and to the fused early-exit kernel."""
    got = SNNAccelerator(Artifact.load(MNIST_ART), mode="event",
                         kernel="cuda", device="cpu").forward(
                             mnist64, latency_mode=True)
    jart = JArtifact.load(MNIST_ART)
    for kernel in ("jnp", "fused"):
        want = JAccelerator(jart, mode="event", kernel=kernel).forward(
            mnist64, latency_mode=True)
        for key in KEYS:
            assert np.array_equal(getattr(got, key).numpy(),
                                  np.asarray(getattr(want, key))), \
                (kernel, key)
    assert (got.steps < 32).any()          # rows exit early


@pytest.mark.parametrize("latency_mode", [False, True])
def test_cuda_engine_matches_jax_engine(mnist64, latency_mode):
    eng = SNNServeEngine(Artifact.load(MNIST_ART), kernel="cuda",
                         latency_mode=latency_mode, device="cpu")
    assert eng.accel.kernel == "cuda" and eng.accel.mode == "event"
    jeng = JEngine(JArtifact.load(MNIST_ART), latency_mode=latency_mode)
    results = []
    for e in (eng, jeng):
        for img in mnist64:
            e.submit(img)
        done = e.flush()
        reqs = [done[r] for r in sorted(done)]
        results.append(([r.label for r in reqs], [r.steps for r in reqs]))
        e.close()
    assert results[0] == results[1]


def test_batch_cuda_scheduler_serves_images(mnist64):
    sched = ServingScheduler(Artifact.load(MNIST_ART),
                             spec="accelerator-batch", kernel="cuda",
                             device="cpu")
    rt = sched.lanes[0].runtime
    assert (rt.mode, rt.kernel) == ("batch", "cuda")
    assert not hasattr(rt, "_w_f32")          # no float32 weight copy
    for img in mnist64:
        sched.submit(img)
    done = sched.drain()
    labels = [done[r].label for r in sorted(done)]
    sched.close()
    want = SNNReference(Artifact.load(MNIST_ART), device="cpu").forward(
        mnist64).labels.tolist()
    assert labels == want
    st = sched.stats()
    assert st["batches"] == 1 and st["overflow_fallbacks"] == 0
