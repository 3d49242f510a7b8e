"""The port's plain fused event→LIF→decode versions against the JAX
package's: its Pallas kernels in interpret mode (``backend="pallas"``) and
their jnp mirrors (``backend="ref"``), bit for bit at small shapes, also in
the CUDA kernels' chunked order of work. The CUDA kernels themselves are
held against these plain versions by chip_smoke.py on the card; here the
host's launch plan is held to what the kernels can run."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.kernels.fused_event_lif import ops as jops
from repro_torch.core import events
from repro_torch.kernels.fused_event_lif import ops, ref

# (B, T, N_in, N_pad, n_groups, per_group, leak_shift, fallback)
CASES = [
    (3, 8, 50, 128, 4, 5, 31, "membrane"),    # leak 31 on negative membranes
    (4, 6, 100, 256, 10, 15, 2, "zero"),
    (2, 10, 37, 128, 3, 7, 5, "membrane"),
]


def _case(B, T, n_in, n_pad, n_out, leak_shift, seed):
    rng = np.random.RandomState(seed)
    times = rng.randint(0, T + 1, (B, n_in)).astype(np.int32)
    times[0] = T                                   # all-PAD row: fallback
    times[-1] = rng.choice([1, 2], size=n_in)      # tie-heavy row
    e_max = jevents.calibrate_e_max(times, T, lane=8)
    w = np.zeros((n_in, n_pad), np.int8)
    drive = rng.randint(-127, 128, (n_in, n_out))
    drive -= 20 * (leak_shift == 31)               # drive membranes negative
    w[:, :n_out] = np.clip(drive, -127, 127)
    thr = np.full((n_pad,), 2**31 - 1, np.int32)
    thr[:n_out] = rng.randint(20, 1500, (n_out,))
    return times, e_max, w, thr


@pytest.mark.parametrize("B,T,n_in,n_pad,G,P,ls,fallback", CASES)
def test_plain_versions_match_jax_kernels(B, T, n_in, n_pad, G, P, ls,
                                          fallback):
    times, e_max, w, thr = _case(B, T, n_in, n_pad, G * P, ls, seed=B + T)
    jf = jevents.pack_events_batched(times, T, e_max)
    tf = events.pack_events_batched(times, T, e_max, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    first, v, labels = ref.fused_event_lif_decode_ref(
        tf.ids, tf.count, tw, tthr, ls, n_out=G * P, n_groups=G,
        per_group=P, fallback=fallback)
    first_x, v_x, steps = ref.fused_event_lif_early_exit_ref(
        tf.ids, tf.count, tw, tthr, ls)
    assert (v[:, :G * P] < 0).any()
    for backend in ("pallas", "ref"):
        jres, jlabels = jops.fused_event_lif_decode(
            jf.ids, jf.count, jnp.asarray(w), jnp.asarray(thr), ls,
            n_out=G * P, n_groups=G, per_group=P, fallback=fallback,
            backend=backend)
        assert np.array_equal(first.numpy(), np.asarray(jres.first_spike))
        assert np.array_equal(v.numpy(), np.asarray(jres.v_final))
        assert np.array_equal(labels.numpy(), np.asarray(jlabels)), backend
        jres_x, jsteps = jops.fused_event_lif_early_exit(
            jf.ids, jf.count, jnp.asarray(w), jnp.asarray(thr), ls,
            backend=backend)
        assert np.array_equal(first_x.numpy(),
                              np.asarray(jres_x.first_spike)), backend
        assert np.array_equal(v_x.numpy(), np.asarray(jres_x.v_final))
        assert np.array_equal(steps.numpy(), np.asarray(jsteps)), backend


def test_plain_version_reads_only_count_slots():
    """Slots at or past count[b, t] are not events, whatever they hold: the
    loop bound of the Pallas kernel and of the CUDA kernel."""
    times, e_max, w, thr = _case(2, 5, 30, 128, 12, 3, seed=0)
    f = events.pack_events_batched(times, 5, e_max, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    want = ref.fused_event_lif_ref(f.ids, f.count, tw, tthr, 3)
    junk = f.ids.clone()
    slot = torch.arange(junk.shape[-1])
    junk[slot.expand_as(junk) >= f.count[..., None]] = 7
    got = ref.fused_event_lif_ref(junk, f.count, tw, tthr, 3)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    times, e_max, w, thr = _case(2, 6, 40, 128, 12, 4, seed=1)
    f = events.pack_events_batched(times, 6, e_max, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    ops.reset_launches()
    res, labels = ops.fused_event_lif_decode(
        f.ids, f.count, tw, tthr, 4, n_out=12, n_groups=3, per_group=4)
    want = ref.fused_event_lif_decode_ref(f.ids, f.count, tw, tthr, 4,
                                          n_out=12, n_groups=3, per_group=4)
    assert torch.equal(res.first_spike, want[0])
    assert torch.equal(res.v_final, want[1])
    assert torch.equal(labels, want[2])
    res_x, steps = ops.fused_event_lif_early_exit(f.ids, f.count, tw, tthr, 4)
    assert torch.equal(steps, ref.fused_event_lif_early_exit_ref(
        f.ids, f.count, tw, tthr, 4)[2])
    res_full = ops.fused_event_lif(f.ids, f.count, tw, tthr, 4)
    assert torch.equal(res_full.first_spike, want[0])
    assert torch.equal(res_full.v_final, want[1])
    assert ops.LAUNCHES == {"fused_event_lif": 0, "fused_event_lif_decode": 0,
                            "fused_event_lif_early_exit": 0}


def test_wrappers_reject_what_the_kernel_does_not_take():
    times, e_max, w, thr = _case(2, 6, 40, 128, 12, 4, seed=2)
    f = events.pack_events_batched(times, 6, e_max, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    with pytest.raises(TypeError, match="int8"):
        ops.fused_event_lif_early_exit(f.ids, f.count, tw.int(), tthr, 4)
    with pytest.raises(ValueError, match="count"):
        ops.fused_event_lif_early_exit(f.ids, f.count[:, :3], tw, tthr, 4)
    with pytest.raises(ValueError, match="leak_shift"):
        ops.fused_event_lif_early_exit(f.ids, f.count, tw, tthr, 32)
    with pytest.raises(ValueError, match="n_groups"):
        ops.fused_event_lif_decode(f.ids, f.count, tw, tthr, 4, n_out=12,
                                   n_groups=5, per_group=4)


@functools.cache
def _jax_results(case_index):
    """The JAX full-T and early-exit results of CASES[case_index], per
    backend: (first, v, first at exit, v at exit, steps) as numpy."""
    B, T, n_in, n_pad, G, P, ls, _ = CASES[case_index]
    times, e_max, w, thr = _case(B, T, n_in, n_pad, G * P, ls, seed=B + T)
    jf = jevents.pack_events_batched(times, T, e_max)
    out = {}
    for backend in ("pallas", "ref"):
        full = jops.fused_event_lif(jf.ids, jf.count, jnp.asarray(w),
                                    jnp.asarray(thr), ls, backend=backend)
        x, steps = jops.fused_event_lif_early_exit(
            jf.ids, jf.count, jnp.asarray(w), jnp.asarray(thr), ls,
            backend=backend)
        out[backend] = tuple(np.asarray(a) for a in (
            full.first_spike, full.v_final, x.first_spike, x.v_final, steps))
    return out


@pytest.mark.parametrize("chunk", [1, 3, "T"])
@pytest.mark.parametrize("case_index", range(len(CASES)))
def test_chunked_plain_versions_match_jax_kernels(case_index, chunk):
    """The kernels' order of work (a chunk's currents gathered before its
    scan, an early exit mid-chunk dropping the rest) gives what JAX's
    kernels give, whatever the chunk."""
    B, T, n_in, n_pad, G, P, ls, _ = CASES[case_index]
    chunk = T if chunk == "T" else chunk
    times, e_max, w, thr = _case(B, T, n_in, n_pad, G * P, ls, seed=B + T)
    tf = events.pack_events_batched(times, T, e_max, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    first, v = ref.fused_event_lif_ref(tf.ids, tf.count, tw, tthr, ls,
                                       chunk=chunk)
    got = (first, v, *ref.fused_event_lif_early_exit_ref(
        tf.ids, tf.count, tw, tthr, ls, chunk=chunk))
    steps = got[-1].numpy()
    assert chunk == 1 or (steps % chunk != 0).any()       # an exit mid-chunk
    for backend, want in _jax_results(case_index).items():
        for g, x in zip(got, want):
            assert np.array_equal(g.numpy(), x), (backend, chunk)


@pytest.mark.parametrize("n_pad", [128, 256, 2048, 4096])
@pytest.mark.parametrize("e_max", [1, 128, 1024])
@pytest.mark.parametrize("T", [1, 8, 32, 33, 64])
def test_launch_plan_is_one_the_kernels_run(T, e_max, n_pad):
    plan = ops.launch_plan(T, e_max, n_pad)
    ops.check_plan(plan, T, e_max, n_pad)
    assert plan.smem_bytes + 1024 <= 227 * 1024          # fits 227 KB
    assert plan.smem_bytes == 4 * plan.chunk * n_pad
    chunks = [min(plan.chunk, T - t0) for t0 in range(0, T, plan.chunk)]
    assert sum(chunks) == T and min(chunks) >= 1          # cover T exactly
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.lanes_per_thread * plan.threads >= n_pad
    # the longest chunk that fits
    assert plan.chunk == T or 4 * (plan.chunk + 1) * n_pad > ops.MAX_CUR_BYTES
    assert ops.launch_plan(T, e_max, n_pad) is plan       # cached
    assert ops.launch_plan(T, e_max, n_pad, max_chunk=8).chunk == min(
        8, plan.chunk)


@pytest.mark.parametrize("n_pad", [0, 4097, 8192])
def test_launch_plan_refuses_what_the_kernels_do_not_take(n_pad):
    with pytest.raises(ValueError, match="N_pad"):
        ops.launch_plan(32, 128, n_pad)


@pytest.mark.parametrize("bad", [
    dict(threads=1000), dict(threads=2048), dict(lanes_per_thread=2),
    dict(chunk=0), dict(chunk=33), dict(smem_bytes=4 * 256 * 31)])
def test_wrappers_refuse_a_plan_the_kernels_cannot_run(bad):
    plan = ops.launch_plan(32, 128, 256)._replace(**bad)
    with pytest.raises(ValueError, match="cannot run"):
        ops.check_plan(plan, 32, 128, 256)
    times, e_max, w, thr = _case(2, 32, 40, 256, 12, 4, seed=3)
    f = events.pack_events_batched(times, 32, 128, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    with pytest.raises(ValueError, match="cannot run"):
        ops.fused_event_lif_early_exit(f.ids, f.count, tw, tthr, 4,
                                       plan=plan)
    with pytest.raises(ValueError, match="cannot run"):
        ops.fused_event_lif_decode(f.ids, f.count, tw, tthr, 4, n_out=12,
                                   n_groups=3, per_group=4, plan=plan)
