"""The port's semantic core against the JAX package, bit for bit, on the CPU:
procedural MNIST, the artifact and its fingerprints, TTFS encode/decode,
event packing, the LIF scans, and lowering (program fingerprints equal the
golden manifest's; the program cache keys by device)."""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.core import lif_dynamics as jlif
from repro.core import ttfs as jttfs
from repro.core.artifact import Artifact as JArtifact
from repro.data import mnist as jmnist
from repro_torch.core import events, lif_dynamics, ttfs
from repro_torch.core.artifact import Artifact, IntegrityError, from_numpy
from repro_torch.core.lowering import (LoweringError, ProgramCache, install,
                                       lower, program_nbytes)
from repro_torch.data import mnist

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MNIST_ART = os.path.join(ASSETS, "mnist_ttfs.npz")
SEEDS = range(8)


def fuzz_artifact(seed: int) -> Artifact:
    with np.load(os.path.join(ASSETS, f"fuzz_seed{seed}.npz")) as z:
        return Artifact.load(io.BytesIO(z["artifact"].tobytes()))


@pytest.mark.parametrize("n,seed", [(64, 8), (200, 1235)])
def test_mnist_generate_is_identical(n, seed):
    x, y = mnist.generate(n, seed)
    jx, jy = jmnist.generate(n, seed)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    assert np.array_equal(x, jx) and np.array_equal(y, jy)


def test_artifact_fingerprint_equals_jax():
    art, jart = Artifact.load(MNIST_ART), JArtifact.load(MNIST_ART)
    assert art.fingerprint() == jart.fingerprint()
    assert art.fingerprint() == art.meta["fingerprint"]
    # the same meta and numpy arrays handed across give the same identity
    assert from_numpy(jart.meta, jart.arrays).fingerprint() == \
        jart.fingerprint()


def test_artifact_tampering_raises(tmp_path):
    art = Artifact.load(MNIST_ART)
    path = str(tmp_path / "a.npz")
    art.save(path)
    Artifact.load(path)                                  # round trip verifies
    flipped = Artifact.load(path)
    flipped.arrays["w_padded"] = flipped.arrays["w_padded"].copy()
    flipped.arrays["w_padded"][0, 0] ^= 1
    with pytest.raises(IntegrityError, match="hash mismatch"):
        flipped.verify()
    meta_edit = Artifact.load(path)
    meta_edit.meta["encode"]["T"] = 31
    with pytest.raises(IntegrityError, match="fingerprint mismatch"):
        meta_edit.verify()


def test_encode_ttfs_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(16, 97).astype(np.float32)
    # bin boundaries and the x_min edge, where a float64 encode would differ
    x[0, :32] = np.arange(32, dtype=np.float32) / 31
    x[1, :4] = [0.0, 1.0 / 255.0, np.nextafter(np.float32(1 / 255), 0), 1.0]
    x[2, :3] = [-0.5, 1.5, 0.5]
    for T, x_min in ((32, 1.0 / 255.0), (11, 0.01)):
        got = ttfs.encode_ttfs(torch.from_numpy(x), T, x_min)
        want = np.asarray(jttfs.encode_ttfs(jnp.asarray(x), T, x_min))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        raster = ttfs.frames_from_times(got, T)
        assert np.array_equal(raster.numpy(),
                              np.asarray(jttfs.frames_from_times(
                                  jnp.asarray(want), T)))


@pytest.mark.parametrize("e_max", [4, 16, 128])
def test_pack_events_and_step_counts_match_jax(e_max):
    rng = np.random.RandomState(e_max)
    T = 9
    times = rng.randint(0, T + 1, (7, 60)).astype(np.int32)
    times[0] = T                                         # all-PAD row
    times[1] = 3                                         # one-tick flood
    got = events.pack_events_batched(times, T, e_max, device="cpu")
    want = jevents.pack_events_batched(times, T, e_max)
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.count.numpy(), np.asarray(want.count))
    assert np.array_equal(got.overflow, np.asarray(want.overflow))
    assert got.overflow.any() == (e_max < 60)
    assert np.array_equal(events.step_counts(times, T),
                          jevents.step_counts(times, T))
    assert events.calibrate_e_max(times, T, lane=8) == \
        jevents.calibrate_e_max(times, T, lane=8)


@pytest.mark.parametrize("leak_shift", [1, 4, 31])
def test_lif_scans_match_jax(leak_shift):
    rng = np.random.RandomState(leak_shift)
    T = 12
    # mostly negative drive: leak_shift 31 must add 1 per step below zero
    cur = rng.randint(-400, 250, (T, 5, 40)).astype(np.int32)
    thr = rng.randint(50, 900, (40,)).astype(np.int32)
    res, vs = lif_dynamics.lif_scan(torch.from_numpy(cur),
                                    torch.from_numpy(thr), leak_shift, T,
                                    return_v_history=True)
    jres, jvs = jlif.lif_scan(jnp.asarray(cur), jnp.asarray(thr), leak_shift,
                              T, return_v_history=True)
    assert np.array_equal(res.first_spike.numpy(), np.asarray(jres.first_spike))
    assert np.array_equal(res.v_final.numpy(), np.asarray(jres.v_final))
    assert np.array_equal(vs.numpy(), np.asarray(jvs))
    assert (res.v_final < 0).any()
    for b in range(cur.shape[1]):
        r, s = lif_dynamics.lif_scan_early_exit(
            torch.from_numpy(cur[:, b]), torch.from_numpy(thr), leak_shift, T)
        jr, js = jlif.lif_scan_early_exit(jnp.asarray(cur[:, b]),
                                          jnp.asarray(thr), leak_shift, T)
        assert int(s) == int(js)
        assert np.array_equal(r.first_spike.numpy(),
                              np.asarray(jr.first_spike))
        assert np.array_equal(r.v_final.numpy(), np.asarray(jr.v_final))


@pytest.mark.parametrize("fallback", ["membrane", "zero"])
def test_decode_labels_matches_jax_on_ties(fallback):
    rng = np.random.RandomState(3)
    G, P, T = 6, 4, 5
    first = rng.choice([1, 2, T], size=(200, G * P)).astype(np.int32)
    first[:40] = T                                       # no spike: fallback
    v = rng.randint(-3, 3, (200, G * P)).astype(np.int32)   # tie-heavy
    got = ttfs.decode_labels(torch.from_numpy(first), torch.from_numpy(v),
                             n_groups=G, per_group=P, sentinel=T,
                             fallback=fallback)
    want = jttfs.decode_labels(jnp.asarray(first), jnp.asarray(v),
                               n_groups=G, per_group=P, sentinel=T,
                               fallback=fallback)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_program_fingerprint_equals_golden_manifest(seed):
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        manifest = json.load(f)
    art = fuzz_artifact(seed)
    assert art.fingerprint() == manifest["fingerprints"][str(seed)]
    prog = lower(art, device="cpu", cache=False)
    assert prog.fingerprint == manifest["program_fingerprints"][str(seed)]
    assert prog.w_padded.dtype == torch.int8
    assert prog.thr_padded.dtype == torch.int32
    assert np.array_equal(prog.w_padded.numpy(), art["w_padded"])


def test_lowering_rejects_bad_meta():
    art = Artifact.load(MNIST_ART)
    bad = from_numpy(art.meta, art.arrays)
    bad.meta["readout"]["n_groups"] = 7
    with pytest.raises(LoweringError, match="readout geometry"):
        lower(bad, device="cpu", cache=False)
    bad = from_numpy(art.meta, art.arrays)
    bad.meta["lif"]["leak_shift"] = 32
    with pytest.raises(LoweringError, match="leak_shift"):
        lower(bad, device="cpu", cache=False)


def test_program_cache_lru_and_orphans():
    cache = ProgramCache(max_bytes=None)
    prev = install(cache)
    try:
        a0, a1 = fuzz_artifact(0), fuzz_artifact(1)
        p0 = lower(a0, device="cpu")
        assert lower(a0, device="cpu") is p0             # cached by content
        assert cache.stats()["program_hits"] == 1
        assert lower(p0, device="cpu") is p0             # same device: as is
        n0 = program_nbytes(p0)
        # a bundle over an uncached program is charged once, as an orphan
        p1 = lower(a1, device="cpu", cache=False)
        cache.bundle(("x", *p1.cache_key), dict, nbytes=program_nbytes(p1))
        cache.bundle(("y", *p1.cache_key), dict, nbytes=program_nbytes(p1))
        assert cache.stats()["orphan_programs"] == 1
        assert cache.bytes == n0 + program_nbytes(p1)
        # installing the program folds its orphan charge in; a budget that
        # fits one program then evicts the least recently used one
        cache.max_bytes = max(n0, program_nbytes(p1))
        lower(a1, device="cpu")
        st = cache.stats()
        assert st["programs"] == 1 and st["orphan_programs"] == 0
        assert st["bundles"] == 2 and st["evictions"] == 1
        assert cache.bytes == program_nbytes(p1)
        assert lower(a0, device="cpu") is not p0         # p0 was evicted
    finally:
        install(prev)
