"""The device spans of the port's prefill path (``telemetry.trace.
device_span``) on tiny dense and MoE ``LM``s on the CPU: off by default,
every op of a prefill under its root and one stage, no user annotation and
no added work, the same logits with tracing on, the MoE counts, and the
benchmark's reader of them (``perfbench/metrics/moe_slot_fill.py``)."""

import argparse
import ast
import dataclasses
import importlib.util
import os
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config, reduced
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.telemetry import trace
from repro_torch.training.lm_step import make_prefill_step

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
READER = os.path.join(ROOT, "perfbench", "metrics", "moe_slot_fill.py")
ARCHS = ("qwen3-8b", "mixtral-8x7b")
STAGES = {"embed", "attn", "ffn", "head"}
SPANS = STAGES | {"prefill", "norm", "rope", "moe_ffn", "moe.route"}
#: the span each inner span opens under
PARENTS = {"embed": {"prefill"}, "attn": {"prefill"}, "ffn": {"prefill"},
           "head": {"prefill"}, "norm": {"attn", "ffn", "head"},
           "rope": {"attn"}, "moe_ffn": {"ffn"}, "moe.route": {"moe_ffn"}}


@pytest.fixture(scope="module")
def models():
    """A prefill step of each tiny model (Mixtral at capacity factor 1.0,
    so that the capacity rule drops) and its ids."""
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        lm = LM(cfg, dtype=torch.float32, device="cpu")
        lm.init_params(torch.Generator().manual_seed(3))
        ids = torch.randint(0, cfg.vocab, (2, 40),
                            generator=torch.Generator().manual_seed(4))
        out[arch] = (lm, make_prefill_step(lm), ids)
    return out


@pytest.fixture(autouse=True)
def fresh_counts():
    trace.reset_device_counts()
    yield
    trace.reset_device_counts()


def _profiled(step, ids, calls=1):
    """``calls`` prefills under a CPU profile -> (logits, the profile)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            logits = step(ids)
    return logits, prof


def _spans(prof):
    return [ev for ev in prof.events() if ev.name in SPANS]


def _spans_per_call(cfg) -> int:
    """Attention, its norm, RoPE, the FFN and its norm in every layer, q's
    and k's norms with qk-norm, the router and ``moe_ffn`` in a MoE layer;
    the root, the embedding, the head and the final norm."""
    per_layer = 5 + 2 * cfg.qk_norm + 2 * bool(cfg.n_experts)
    return per_layer * cfg.n_layers + 4


def test_off_a_site_returns_the_shared_null_context_and_counts_nothing(
        models):
    assert trace.device_span("attn") is trace._NULL_CTX
    with trace.device_span("attn") as span:
        assert span is None
    trace.device_count("moe_ffn.slots", 8)
    trace.device_count("moe_ffn.kept", torch.ones(3, dtype=torch.bool))
    _, step, ids = models["mixtral-8x7b"]
    step(ids)
    assert trace.device_counts() == {} and trace._pending == []


@pytest.mark.parametrize("arch", ARCHS)
def test_every_op_of_a_prefill_lies_under_its_root_and_one_stage(models,
                                                                 arch):
    _, step, ids = models[arch]
    _, prof = _profiled(step, ids)
    ops = [ev for ev in prof.events() if ev.name.startswith("aten::")]
    assert ops
    for ev in ops:
        names, up = set(), ev
        while up is not None:
            names.add(up.name)
            up = up.cpu_parent
        assert "prefill" in names and names & STAGES, (ev.name, names)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_span_is_a_user_annotation(models, arch):
    """``record_function`` ranges are user annotations, which the profiler
    mirrors onto the device as if they were operations; the program's
    ranges are not."""
    _, step, ids = models[arch]
    _, prof = _profiled(step, ids)
    assert {"prefill", "embed", "attn", "ffn", "head", "norm",
            "rope"} <= {ev.name for ev in prof.events()}
    assert not [ev.name for ev in prof.events() if ev.is_user_annotation]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_spans_add_no_op(models, arch, monkeypatch):
    """A traced prefill runs the same ops, in the same order, with the
    spans as without them."""
    _, step, ids = models[arch]

    def ops():
        _, prof = _profiled(step, ids)
        return [ev.name for ev in prof.events() if ev.name not in SPANS]

    with_spans = ops()
    monkeypatch.setattr(trace, "device_span", lambda name: trace._NULL_CTX)
    assert ops() == with_spans


def test_the_port_opens_no_record_function_range():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    tree = ast.parse(fh.read())
                attrs = {n.attr for n in ast.walk(tree)
                         if isinstance(n, ast.Attribute)}
                names = {n.id for n in ast.walk(tree)
                         if isinstance(n, ast.Name)}
                assert "record_function" not in attrs | names, f


@pytest.mark.parametrize("arch", ARCHS)
def test_the_logits_are_the_same_bits_with_tracing_on(models, arch):
    _, step, ids = models[arch]
    off = step(ids)
    on, _ = _profiled(step, ids)
    assert torch.equal(off, on)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_root_a_call_and_the_spans_nest(models, arch):
    lm, step, ids = models[arch]
    _, prof = _profiled(step, ids, calls=3)
    spans = _spans(prof)
    roots = [ev for ev in spans if ev.name == "prefill"]
    assert len(roots) == 3 and all(ev.cpu_parent is None for ev in roots)
    stages = [ev.name for ev in spans
              if ev.cpu_parent is not None and ev.cpu_parent.name == "prefill"]
    assert stages == (["embed"] + ["attn", "ffn"] * lm.cfg.n_layers +
                      ["head"]) * 3
    for ev in spans:
        if ev.name != "prefill":
            assert ev.cpu_parent.name in PARENTS[ev.name], ev.name


@pytest.mark.parametrize("arch", ARCHS)
def test_a_call_opens_each_span_name_as_the_benchmark_counts_it(models,
                                                                arch):
    lm, step, ids = models[arch]
    _, prof = _profiled(step, ids)
    got = Counter(ev.name for ev in _spans(prof))
    n = lm.cfg.n_layers
    want = {"prefill": 1, "embed": 1, "head": 1, "attn": n, "ffn": n,
            "rope": n, "norm": n * (2 + 2 * lm.cfg.qk_norm) + 1}
    if lm.cfg.n_experts:
        want.update({"moe_ffn": n, "moe.route": n})
    assert got == want and sum(got.values()) == _spans_per_call(lm.cfg)


def test_qwen3_8b_opens_256_spans_a_call_and_mixtral_16l_116():
    assert _spans_per_call(get_config("qwen3-8b")) == 256
    assert _spans_per_call(
        dataclasses.replace(get_config("mixtral-8x7b"), n_layers=16)) == 116


def test_moe_ffn_counts_the_assignments_it_kept(models, monkeypatch):
    lm, step, ids = models["mixtral-8x7b"]
    keeps = []
    real = moe.route

    def logged(*args, **kw):
        r = real(*args, **kw)
        keeps.append((r.keep, r.capacity))
        return r

    monkeypatch.setattr(moe, "route", logged)
    _profiled(step, ids, calls=2)
    assert len(keeps) == 2 * lm.cfg.n_layers
    E, B = lm.cfg.n_experts, ids.shape[0]
    counts = trace.device_counts()
    assert counts["moe_ffn.kept"] == sum(int(k.sum()) for k, _ in keeps)
    assert counts["moe_ffn.slots"] == sum(E * B * C for _, C in keeps)
    # the capacity rule dropped somewhere, so the count is not the total
    assert counts["moe_ffn.kept"] < \
        2 * lm.cfg.n_layers * ids.numel() * lm.cfg.top_k


def test_a_dense_model_counts_nothing(models):
    _, step, ids = models["qwen3-8b"]
    _profiled(step, ids)
    assert trace.device_counts() == {}


def test_counts_are_taken_only_while_a_profiler_runs_and_reset_empties():
    keep = torch.tensor([True, False, True])
    trace.device_count("kept", keep)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.device_count("kept", keep)
        trace.device_count("slots", 4)
    trace.device_count("slots", 4)
    assert trace.device_counts() == {"kept": 2, "slots": 4}
    trace.reset_device_counts()
    assert trace.device_counts() == {}


def test_pending_sums_are_added_at_the_bound():
    """A profiler whose owner never reads the counts holds at most
    ``_MAX_PENDING`` tensors."""
    n = trace._MAX_PENDING + 10
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            trace.device_count("kept", torch.ones(2, dtype=torch.bool))
            assert len(trace._pending) < trace._MAX_PENDING
    assert trace.device_counts() == {"kept": 2 * n}


def _reader():
    spec = importlib.util.spec_from_file_location("perfbench_metric_msf",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(trace_summary):
    return argparse.Namespace(config={}, traffic={}, window={},
                              trace=trace_summary, counts=None)


def test_moe_slot_fill_reads_the_counts_of_a_traced_stretch(models):
    _, step, ids = models["mixtral-8x7b"]
    _profiled(step, ids, calls=2)
    c = trace.device_counts()
    got = _reader().read(_ctx({"device_s": 1.0}))
    assert got == pytest.approx(100.0 * c["moe_ffn.kept"] /
                                c["moe_ffn.slots"])
    assert 0 < got < 100


@pytest.mark.parametrize("summary", [None, {"device_s": 0.0}],
                         ids=["no trace", "no device time"])
def test_moe_slot_fill_reads_nothing_without_a_traced_device(models,
                                                             summary):
    _, step, ids = models["mixtral-8x7b"]
    _profiled(step, ids)
    assert _reader().read(_ctx(summary)) is None


def test_moe_slot_fill_reads_nothing_where_the_program_counted_nothing(
        monkeypatch):
    reader = _reader()
    assert reader.read(_ctx({"device_s": 1.0})) is None
    # a program without the counts, as the benchmark's parent commit
    monkeypatch.delattr(trace, "device_counts")
    assert reader.read(_ctx({"device_s": 1.0})) is None
