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

from repro.core import events as jevents
from repro.core import lif_dynamics as jlif
from repro.core.accelerator import SNNAccelerator as JAccelerator
from repro.core.artifact import Artifact as JArtifact
from repro.kernels.event_accum.ops import event_accum as j_event_accum
from repro.kernels.fused_event_lif import ops as jfused
from repro.kernels.lif.ops import lif_fused as j_lif_fused
from repro.kernels.spike_matmul.ops import spike_matmul as j_spike_matmul
from repro.kernels.ttfs_decode.ops import ttfs_decode as j_ttfs_decode
from repro.serving.snn_engine import SNNServeEngine as JEngine
from repro_torch.core import events, lif_dynamics
from repro_torch.core.accelerator import SNNAccelerator
from repro_torch.core.artifact import Artifact
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
