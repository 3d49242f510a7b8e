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


@pytest.mark.parametrize("n_pad", [0, ops.MAX_N_PAD + 1, 2 * ops.MAX_N_PAD])
def test_launch_plan_refuses_what_the_kernels_do_not_take(n_pad):
    with pytest.raises(ValueError, match=f"N_pad={n_pad} is not in "
                       f"1..{ops.MAX_N_PAD}"):
        ops.launch_plan(32, 128, n_pad)


@pytest.mark.parametrize("n_pad", [4097, 6000, 8192, 8193, 12_289, 16_384,
                                   20_000, 32_767, ops.MAX_N_PAD])
@pytest.mark.parametrize("T", [1, 8, 32])
def test_launch_plan_splits_a_wide_row_over_a_cluster(T, n_pad):
    """A row wider than one block's 4096 lanes runs on the smallest cluster
    of 2, 4 or 8 blocks, each owning a slice of at most 4096 lanes (a
    multiple of 16), the last slice not empty; the plan is one the kernels
    take, and so is every chunk of it."""
    assert ops.MAX_N_PAD == 32_768
    plan = ops.launch_plan(T, 128, n_pad)
    ops.check_plan(plan, T, 128, n_pad)
    width = ops.slice_lanes(n_pad, plan.cluster)
    assert plan.cluster in (2, 4, 8)
    assert plan.cluster // 2 * 4096 < n_pad <= plan.cluster * 4096
    assert width % 16 == 0 and width <= 4096
    assert 0 < n_pad - width * (plan.cluster - 1) <= width
    assert plan.smem_bytes == 4 * plan.chunk * width
    assert plan.lanes_per_thread * plan.threads >= width
    assert plan.chunk == T or 4 * (plan.chunk + 1) * width > ops.MAX_CUR_BYTES
    ops.check_plan(ops.launch_plan(T, 128, n_pad, max_chunk=1), T, 128, n_pad)
    for bad in (dict(cluster=plan.cluster // 2), dict(cluster=3),
                dict(cluster=16)):
        with pytest.raises(ValueError, match="cannot run"):
            ops.check_plan(plan._replace(**bad), T, 128, n_pad)


def test_plans_at_most_4096_lanes_keep_one_block():
    for n_pad in (1, 128, 256, 257, 4096):
        assert ops.launch_plan(32, 128, n_pad).cluster == 1
    # a narrow row may still be split (the kernels take it), but not one
    # whose gathering lanes own 4 or 8 columns
    plan = ops.launch_plan(32, 128, 2048)
    ops.check_plan(plan._replace(cluster=2, smem_bytes=4 * plan.chunk * 1024),
                   32, 128, 2048)
    with pytest.raises(ValueError, match="cannot run"):
        ops.check_plan(ops.launch_plan(32, 128, 256)._replace(
            cluster=2, smem_bytes=4 * 32 * 128), 32, 128, 256)


# (B, T, N_in, N_pad, n_groups, per_group, leak_shift, fallback): rows wider
# than one block, which the card runs on a thread-block cluster
WIDE = [
    (2, 8, 40, 8192, 16, 500, 3, "membrane"),
    (2, 8, 33, 4097, 7, 585, 31, "zero"),
]


@pytest.mark.parametrize("B,T,n_in,n_pad,G,P,ls,fallback", WIDE)
def test_wide_rows_match_jax_kernels(B, T, n_in, n_pad, G, P, ls, fallback):
    """The full-T, decode and early-exit versions at N_pad 8192 and 4097
    (cluster plans of 2 blocks), bit for bit against JAX's Pallas kernels in
    interpret mode and their jnp mirrors. JAX's full-T kernel without the
    decode tiles N_pad by 128, so at 4097 it is held through the decode
    kernel's first spikes and membranes, which are the same state."""
    times, e_max, w, thr = _case(B, T, n_in, n_pad, G * P, ls, seed=n_pad)
    jf = jevents.pack_events_batched(times, T, e_max)
    tf = events.pack_events_batched(times, T, e_max, device="cpu")
    tw, tthr = torch.from_numpy(w), torch.from_numpy(thr)
    plan = ops.launch_plan(T, e_max, n_pad)
    assert plan.cluster == 2
    dec_kw = dict(n_out=G * P, n_groups=G, per_group=P, fallback=fallback)
    # the wrappers take the cluster plan (checked on the CPU too)
    res, labels = ops.fused_event_lif_decode(tf.ids, tf.count, tw, tthr, ls,
                                             **dec_kw, plan=plan)
    res_x, steps = ops.fused_event_lif_early_exit(tf.ids, tf.count, tw, tthr,
                                                  ls, plan=plan)
    full = ops.fused_event_lif(tf.ids, tf.count, tw, tthr, ls, plan=plan)
    assert torch.equal(full.first_spike, res.first_spike)
    assert torch.equal(full.v_final, res.v_final)
    assert (res.first_spike[:, :G * P] < T).any()          # lanes fire
    jw, jthr = jnp.asarray(w), jnp.asarray(thr)
    for backend in ("pallas", "ref"):
        jres, jlabels = jops.fused_event_lif_decode(
            jf.ids, jf.count, jw, jthr, ls, **dec_kw, backend=backend)
        assert np.array_equal(res.first_spike.numpy(),
                              np.asarray(jres.first_spike)), backend
        assert np.array_equal(res.v_final.numpy(), np.asarray(jres.v_final))
        assert np.array_equal(labels.numpy(), np.asarray(jlabels)), backend
        jx, jsteps = jops.fused_event_lif_early_exit(
            jf.ids, jf.count, jw, jthr, ls, backend=backend)
        assert np.array_equal(res_x.first_spike.numpy(),
                              np.asarray(jx.first_spike)), backend
        assert np.array_equal(res_x.v_final.numpy(), np.asarray(jx.v_final))
        assert np.array_equal(steps.numpy(), np.asarray(jsteps)), backend
        if n_pad % 128 == 0 or backend == "ref":
            jfull = jops.fused_event_lif(jf.ids, jf.count, jw, jthr, ls,
                                         backend=backend)
            assert np.array_equal(full.first_spike.numpy(),
                                  np.asarray(jfull.first_spike)), backend
            assert np.array_equal(full.v_final.numpy(),
                                  np.asarray(jfull.v_final)), backend


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
