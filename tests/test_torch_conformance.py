"""The port's conformance suite and telemetry exporters against the JAX
package on the CPU: ``fuzz_case`` equal seed for seed (artifact
fingerprint, images, times, notes; exact), ``golden.check`` clean on
``tests/golden/`` (the JAX package's snapshots, bit for bit), ``run_case``
running all of JAX's oracles (none left unported) with each oracle's
verdict equal to JAX's, the fault-recovery oracle on the pinned seeds
beside JAX's, a divergent runtime caught, and the JSONL
and Prometheus exporters writing what JAX's write for the same contents."""

import contextlib
import os

import numpy as np
import pytest
import torch

from repro.conformance import fuzz_case as jfuzz_case
from repro.conformance import run_case as jrun_case
from repro.conformance.fuzz import images_from_times as jimages_from_times
from repro.conformance.oracles import \
    _fault_recovery_oracle as _jfault_recovery_oracle
from repro.core.runtimes import make_runtime as jmake_runtime
from repro.telemetry import export as jexport
from repro.telemetry import trace as jtrace
from repro.telemetry.metrics import MetricsRegistry as JRegistry
from repro_torch.conformance import fuzz_case, golden, run_case
from repro_torch.conformance.fuzz import images_from_times
from repro_torch.conformance.oracles import (NOT_PORTED,
                                             _fault_recovery_oracle)
from repro_torch.core import runtimes, ttfs
from repro_torch.core.runtimes import make_runtime
from repro_torch.core.types import SNNOutput
from repro_torch.telemetry import export
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.metrics import MetricsRegistry

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_case_equals_jax(seed):
    got, want = fuzz_case(seed), jfuzz_case(seed)
    assert got.artifact.fingerprint() == want.artifact.fingerprint()
    for k, a in want.artifact.arrays.items():
        assert got.artifact.arrays[k].tobytes() == a.tobytes(), k
    assert got.artifact.meta == want.artifact.meta
    for f in ("images", "times"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.notes == want.notes and got.seed == want.seed


def test_images_from_times_roundtrip_and_validation():
    T = 16
    times = np.array([[0, 5, T - 2, T, T]])
    imgs = images_from_times(times, T)
    assert np.array_equal(imgs, jimages_from_times(times, T))
    assert np.array_equal(
        ttfs.encode_ttfs(torch.from_numpy(imgs), T, 1 / 255).numpy(), times)
    with pytest.raises(ValueError, match=r"T-2"):
        images_from_times(np.array([[T - 1]]), T)
    with pytest.raises(ValueError, match="too small"):
        images_from_times(np.array([[0]]), 3)


@pytest.mark.parametrize("seed", golden.PINNED_SEEDS)
def test_golden_check_is_clean(seed):
    """The port regenerates the JAX package's committed snapshot of each
    pinned seed bit for bit (arrays and both fingerprints)."""
    assert golden.GOLDEN_DIR == os.path.normpath(GOLDEN)
    assert golden.check(seeds=[seed], device="cpu") == []


def test_golden_detects_tamper_and_missing(tmp_path):
    d = str(tmp_path)
    golden.regen(d, seeds=(0, 1), device="cpu")
    assert golden.check(dirpath=d, device="cpu") == []
    p = golden.golden_path(1, d)
    with np.load(p) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["labels"][0] += 1
    np.savez(p, **arrays)
    os.remove(golden.golden_path(0, d))
    diffs = golden.check(dirpath=d, device="cpu")
    assert any(x.seed == 1 and x.array == "labels" for x in diffs), diffs
    assert any(x.seed == 0 and x.array == "<missing>" for x in diffs), diffs
    assert "manifest" in golden.check(dirpath=str(tmp_path / "none"),
                                      device="cpu")[0].detail


def test_golden_regen_needs_its_directory(capsys):
    """tests/golden/ belongs to the JAX package: the port's regen writes
    only where it is told."""
    with pytest.raises(TypeError):
        golden.regen()                                # noqa: the missing dir
    with pytest.raises(SystemExit):
        golden.main(["--regen", "--device", "cpu"])
    assert "--dir" in capsys.readouterr().err


@pytest.fixture(scope="module")
def reports():
    return {seed: (run_case(fuzz_case(seed), device="cpu"),
                   jrun_case(jfuzz_case(seed))) for seed in (11, 12)}


def _verdicts(rep) -> dict:
    out = {}
    for o in rep.outcomes:
        out[o.oracle] = out.get(o.oracle, True) and o.passed
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_oracle_stack_passes_like_jax(reports, seed):
    rep, jrep = reports[seed]
    assert rep.passed, rep.summary()
    got, want = _verdicts(rep), _verdicts(jrep)
    assert set(got) == set(want)
    assert rep.not_ported == {} == NOT_PORTED
    assert {"program-io", "transport", "fault-recovery"} <= set(got)
    assert len(rep.outcomes) == len(jrep.outcomes)
    for oracle, ok in got.items():
        assert ok == want[oracle], oracle
    for oracle in ("program-io", "transport"):
        (o,) = [o for o in rep.outcomes if o.oracle == oracle]
        (jo,) = [o for o in jrep.outcomes if o.oracle == oracle]
        assert o.stats == jo.stats, oracle
    assert "not ported, not run: none" in rep.summary()
    diff = {o.spec for o in rep.outcomes if o.oracle == "differential"}
    assert diff == set(runtimes.ADVERTISED_SPECS) - {"reference"}


@pytest.mark.parametrize("seed", golden.PINNED_SEEDS)
def test_fault_recovery_oracle_passes_like_jax(seed):
    """The fault-recovery oracle on each pinned seed: the scheduler's one
    lane crashes on its first batch, recovers, and serves every image with
    the reference label; the recovery ledger equals JAX's."""
    case, jcase = fuzz_case(seed), jfuzz_case(seed)
    out_ref = make_runtime(case.artifact, "reference",
                           device="cpu").forward(case.images)
    got = _fault_recovery_oracle(case, out_ref, torch.device("cpu"))
    want = _jfault_recovery_oracle(
        jcase, jmake_runtime(jcase.artifact, "reference").forward(
            jcase.images))
    assert got.passed and want.passed, (got.detail, want.detail)
    assert (got.oracle, got.spec) == (want.oracle, want.spec)
    for k in ("lane_faults", "lane_restarts", "recoveries"):
        assert got.stats[k] == want.stats[k] == 1, k
    assert got.stats["requeued"] >= 1 and want.stats["requeued"] >= 1


class _Divergent:
    """The reference with one label and one first-spike time flipped."""

    def __init__(self, prog):
        self._ref = make_runtime(prog, "reference", device=prog.device)

    def forward(self, images):
        out = self._ref.forward(images)
        labels = out.labels.clone()
        labels[0] = (labels[0] + 1) % max(2, int(labels.max()) + 1)
        first = out.first_spike.clone()
        first[0, 0] += 1
        return SNNOutput(labels, first, out.v_final, out.steps)


@contextlib.contextmanager
def _divergent_family(name="divergent"):
    runtimes._REGISTRY[name] = lambda prog, opts, **kw: _Divergent(prog)
    try:
        yield
    finally:
        del runtimes._REGISTRY[name]


def test_divergent_runtime_is_caught_not_swallowed():
    with _divergent_family():
        rep = run_case(fuzz_case(3), specs=("divergent",), device="cpu")
    assert not rep.passed
    by_oracle = {o.oracle: o for o in rep.failures()}
    assert "divergent" in by_oracle["registry"].detail
    diff = by_oracle["differential"]
    assert diff.spec == "divergent"
    assert diff.stats["labels"] == 1 and diff.stats["first_spike"] == 1
    assert "mismatches on 1 images" in diff.detail
    assert "FAIL [differential] divergent" in rep.summary()
    assert "divergent" not in runtimes.available()


def _board_tracer(trace_mod, make, images):
    t = trace_mod.Tracer()
    prev = trace_mod.install(t)
    try:
        make().forward(images)
    finally:
        trace_mod.install(prev)
    return t


def test_jsonl_roundtrip_equals_jax(tmp_path):
    """A traced board run dumped by each package: the port's dump reads
    back span for span, and its canonical lines equal JAX's."""
    case, jcase = fuzz_case(5), jfuzz_case(5)
    t = _board_tracer(ttrace, lambda: make_runtime(
        case.artifact, "board", device="cpu"), case.images)
    jt = _board_tracer(jtrace, lambda: jmake_runtime(jcase.artifact,
                                                     "board"), jcase.images)
    path = str(tmp_path / "sub" / "spans.jsonl")
    n = export.write_jsonl(t, path)
    jpath = str(tmp_path / "jax.jsonl")
    assert n == jexport.write_jsonl(jt, jpath) == len(t.sorted_spans()) > 0
    rows = export.read_jsonl(path)
    assert rows == [s.full() for s in t.sorted_spans()]
    assert export.canonical_lines(path) == jexport.canonical_lines(jpath)


def _fill(reg):
    reg.inc("lane_faults", 3)
    reg.inc("images_out", 2.5)
    reg.set_gauge("queue_depth", 7)
    reg.set_gauge("flag", True)
    for v in (10.0, 75.0, 300.0, 2e6):
        reg.observe("request_latency_us", v)


def test_prometheus_text_equals_jax():
    reg, jreg = MetricsRegistry(), JRegistry()
    _fill(reg)
    _fill(jreg)
    assert export.prometheus_text(reg) == jexport.prometheus_text(jreg)
    assert export.prometheus_text(reg, prefix="") == \
        jexport.prometheus_text(jreg, prefix="")


class _Cache:
    def __init__(self, max_bytes):
        self.st = {"evictions": 2, "program_hits": 5, "program_misses": 1,
                   "bundle_hits": 4, "bundle_misses": 3, "bytes": 33629,
                   "programs": 1, "bundles": 2, "max_bytes": max_bytes}

    def stats(self):
        return self.st


@pytest.mark.parametrize("max_bytes", [None, 1 << 30])
def test_program_cache_text_equals_jax(max_bytes):
    cache = _Cache(max_bytes)
    assert export.program_cache_text(cache) == \
        jexport.program_cache_text(cache)
    assert "repro_program_cache_bytes 33629\n" in \
        export.program_cache_text(cache)
    assert "# TYPE repro_program_cache_bytes gauge" in \
        export.program_cache_text()                  # the active cache
