"""The harness on the CPU: a whole run of each tiny cell, cells and metrics
found by name, ``BENCHMARK.json`` against the benchmark's contract, the
counts against hand counts, and no import of JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import math
import re
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, tiny_bench
from perfbench import counts, run
from perfbench import weights as W

SEED = 2 ** 32 + 3
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = ["tiny-qwen3.prefill", "tiny-mixtral.prefill"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_reports_its_metrics(tiny_root, name, trace):
    bench = tiny_bench()
    cell = run.load_cell(bench, name, seed=SEED, trace=bool(trace),
                         device="cpu", root=tiny_root)
    result, compared = run.run_cell(cell, 0.3, 0.0, tiny_root)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(compared) == set(cell.limits)
    if trace:
        # a CPU run has no device trace: only the host's readers report
        assert set(result["metrics"]) == {"prefill_mfu", "idle_share.prefill"}
        assert "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert "setup_s" in result["metrics"]


def test_new_cells_and_metrics_are_files(tiny_root):
    """A new traffic mix, configuration and per-layer metric are found by
    their names in BENCHMARK.json, with no edit to the harness."""
    traffic = json.loads((tiny_root / "traffic" / "prefill.json").read_text())
    (tiny_root / "traffic" / "prefill-b1.json").write_text(
        json.dumps({**traffic, "batch": 1, "seq": 20}))
    cfg = json.loads((tiny_root / "configs" / "tiny-qwen3.json").read_text())
    (tiny_root / "configs" / "tiny-wide.json").write_text(
        json.dumps({**cfg, "name": "tiny-wide", "num_hidden_layers": 3}))
    (tiny_root / "workloads" / "tiny-wide.prefill-b1.json").write_text(
        json.dumps({"limits": {"logit_err_mean": 0.05,
                               "logit_err_max": 0.2}}))
    (tiny_root / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return ctx.window['calls']\n")
    bench = tiny_bench()
    bench["workloads"].append({"name": "tiny-wide.prefill-b1",
                               "config": "tiny-wide", "traffic": "prefill-b1",
                               "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("prefill_tokens_per_s", "prefill_ms_p90"):
            m["workloads"].append("tiny-wide.prefill-b1")
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step",
                               "moves": "prefill_tokens_per_s"})
    cell = run.load_cell(bench, "tiny-wide.prefill-b1", seed=SEED,
                         trace=True, device="cpu", root=tiny_root)
    result, _ = run.run_cell(cell, 0.2, 0.0, tiny_root)
    assert result["correct"]
    assert result["metrics"]["calls_seen"]["value"] == result["attempted"]


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    metrics = b["end_to_end"] + b["per_layer"]
    for what, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"})):
        for e in b[what]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]), e["name"]
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in metrics:
        allowed = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if m in b["end_to_end"] else {"layer", "moves"})
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}, m
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [e["name"] for e in b["configs"] + b["workloads"]] + \
        [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in metrics:
        assert set(m.get("workloads", ())) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "traffic" / f"{traffic['driver']}.py").exists()
        assert json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())["limits"]
        reported = [m for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= 1
    for f in BENCH.rglob("*"):
        if "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(f.relative_to(ROOT))), f


def test_counts_match_hand_counts():
    """Published totals: Qwen3-8B 8.2 B parameters, 6.95 B without the
    embedding and head; Mixtral-8x7B 46.7 B, 12.9 B active (32 layers)."""
    def total(cfg):
        return sum(math.prod(lf.shape) for lf in W.leaves(cfg))
    q = json.loads((BENCH / "configs" / "qwen3-8b.json").read_text())
    m = json.loads((BENCH / "configs" / "mixtral-8x7b-16l.json").read_text())
    head = 4096 * 151_936
    assert total(q) == 8_190_735_360
    assert total(q) - 2 * head == 6_946_075_648
    # per layer: q, k, v, o; gate, up, down; two norms, q and k norms
    layer = 4096 * (4096 + 2 * 1024) + 4096 * 4096 + 3 * 4096 * 12_288
    assert counts.matmul_params(q) == 36 * layer + head
    m32 = {**m, "num_hidden_layers": 32}
    assert abs(total(m32) - 46.7e9) / 46.7e9 < 0.001
    attn = 4096 * (4096 + 2 * 1024) + 4096 * 4096
    assert counts.matmul_params(m32) == 32 * (
        attn + 2 * 3 * 4096 * 14_336 + 4096 * 8) + 4096 * 32_000
    assert abs(counts.matmul_params(m32) + 4096 * 32_000 - 12.9e9) / 12.9e9 \
        < 0.005
    # attention's bound at phase 7's shapes (PERF.md's table, row 8a)
    assert counts.attn_bound_s(q, 1, 4096) * 1e3 == pytest.approx(0.139002,
                                                                 abs=1e-6)
    assert counts.attn_bound_s(q, 2, 4096) * 1e3 == pytest.approx(0.278003,
                                                                 abs=1e-6)
    assert counts.attn_bound_s(q, 1, 32768) * 1e3 == pytest.approx(
        8.894198, abs=1e-6)
    assert counts.prefill_flops(q, 2, 4096) == 2 * counts.matmul_params(q) \
        * 8192 + 36 * 4 * 2 * 32 * (4096 * 4097 // 2) * 128
    assert counts.visible_pairs(10, 4) == 4 * 5 // 2 + 6 * 4


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = [f for f in BENCH.rglob("*.py") if "__pycache__" not in f.parts]
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f
        assert "benchmarks" + "/" not in f.read_text(), f
    yardstick = list((BENCH / "reference").glob("*.py")) + [
        BENCH / n for n in ("weights.py", "compare.py", "counts.py")]
    for f in yardstick:
        assert not _imports(f) & {"repro_torch"}, f


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import types
    assert "repro_torch" in __import__("sys").modules
    assert run.forbidden_modules() == []
    monkeypatch.setitem(__import__("sys").modules, "repro",
                        types.ModuleType("repro"))
    assert run.forbidden_modules() == ["repro"]


def test_a_run_without_a_card_prints_nothing_and_fails(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert run.main(["--workload", "qwen3-8b.prefill-2x4k", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_the_trace_reduction_unions_spans_and_labels_every_gap():
    from perfbench import trace
    assert trace._union([(0, 5), (3, 8), (10, 12)]) == (10, [(8, 10)])
    cpu = [(0, 100, "outer"), (10, 20, "inner"), (30, 31, "launch"),
           (60, 90, "sync")]
    got = trace._by_host(cpu, [(21, 25), (31, 35), (70, 80), (95, 99),
                               (101, 105)])
    assert got == pytest.approx({"outer": 12e-6, "sync": 10e-6,
                                 "host Python, no op": 4e-6})
