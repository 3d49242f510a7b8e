"""CPU tests of the benchmark, and the card tests (marker ``card``: each
decides inside the test whether there is a card and skips without one).

    PYTHONPATH=src python -m pytest perfbench/tests -q

A tiny benchmark root (``tiny_root``) holds the harness's drivers and
readers beside tiny configurations of both families, so a whole run goes
through ``run_cell`` on the CPU.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {
    "name": "tiny-qwen3", "model_type": "qwen3", "hidden_size": 64,
    "head_dim": 16, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000, "sliding_window": None, "torch_dtype": "bfloat16",
    "vocab_size": 256, "tie_word_embeddings": False}
TINY_MOE = {
    "name": "tiny-mixtral", "model_type": "mixtral", "hidden_size": 64,
    "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "num_local_experts": 4,
    "num_experts_per_tok": 2, "rms_norm_eps": 1e-5, "rope_theta": 1000000.0,
    "sliding_window": 24, "torch_dtype": "bfloat16", "vocab_size": 256,
    "capacity_factor": 1.0, "tie_word_embeddings": False}
TINY_TRAFFIC = {"driver": "prefill_batches", "batch": 2, "seq": 48,
                "warm_calls": 1, "check_calls": 2, "check_within": 3,
                "trace_calls": 1}
#: limits at the tiny sizes: the bf16 program reads well under them, the
#: faults far over them
TINY_LIMITS = {"logit_err_mean": 0.02, "logit_err_max": 0.2}
TINY_MOE_LIMITS = {"logit_err_mean": 0.02, "logit_err_p999": 0.2,
                   "route_flip_share": 0.02, "drop_mismatch": 0}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


def tiny_bench() -> dict:
    """``BENCHMARK.json`` with the tiny cells, ``<config>.prefill``, in
    place of its own, each metric listing them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [{"name": f"{cfg}.prefill", "config": cfg, "traffic": "prefill",
              "chips": 1, "why": "tiny"}
             for cfg in ("tiny-qwen3", "tiny-mixtral")]
    names = [c["name"] for c in cells]
    metrics = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = [n for n in names if m.get("layer") != "MoE"
                              or "mixtral" in n]
        metrics.append(m)
    return {**bench, "workloads": cells,
            "end_to_end": metrics[:len(bench["end_to_end"])],
            "per_layer": metrics[len(bench["end_to_end"]):]}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "perfbench")


def make_tiny_root(root: Path) -> Path:
    """A benchmark root at ``root``: the harness's drivers and readers, the
    tiny configurations, their traffic and limits."""
    shutil.copytree(BENCH / "metrics", root / "metrics")
    (root / "traffic").mkdir()
    for f in (BENCH / "traffic").glob("*.py"):
        shutil.copy(f, root / "traffic" / f.name)
    (root / "traffic" / "prefill.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    for cfg in (TINY_DENSE, TINY_MOE):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        lim = TINY_MOE_LIMITS if "num_local_experts" in cfg else TINY_LIMITS
        (root / "workloads" / f"{cfg['name']}.prefill.json").write_text(
            json.dumps({"limits": lim}))
    return root
