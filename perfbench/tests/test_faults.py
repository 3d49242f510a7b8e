"""Each fault the cells can have (``perfbench/faults.py``), planted under a
whole tiny run on the CPU (the look for a card skipped), turns ``correct``
false; so does the control, the reference in float8 put in the program's
place, through ``run_cell``, on the limits the program meets."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_bench
from perfbench import control, faults, run

SEED = 2 ** 32 + 11


def _run(root, name, control=False):
    cell = run.load_cell(tiny_bench(), name, seed=SEED, trace=False,
                         device="cpu", root=root)
    result, compared = run.run_cell(cell, 0.3, 0.0, root, control=control)
    return result["correct"], compared


@pytest.mark.parametrize("cfg,fault", [
    ("tiny-qwen3", "answer"), ("tiny-qwen3", "half_batch"),
    ("tiny-mixtral", "answer"), ("tiny-mixtral", "half_batch"),
    ("tiny-mixtral", "route_third")])
def test_faults_are_not_correct(tiny_root, cfg, fault):
    assert _run(tiny_root, f"{cfg}.prefill")[0]
    with faults.plant(fault, SEED):
        ok, compared = _run(tiny_root, f"{cfg}.prefill")
    assert not ok, compared


@pytest.mark.parametrize("name", ["tiny-qwen3.prefill", "tiny-mixtral.prefill"])
def test_the_control_is_not_correct(tiny_root, name):
    ok, compared = _run(tiny_root, name, control=True)
    assert not ok, compared
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("name", ["tiny-qwen3.prefill", "tiny-mixtral.prefill"])
def test_the_readings_judge_program_and_control_apart(tiny_root, name):
    cell = run.load_cell(tiny_bench(), name, seed=SEED, trace=False,
                         device="cpu", root=tiny_root)
    r = control.readings(cell, 0.3, control=True)
    assert r["correct"] and not r["control_correct"], r
