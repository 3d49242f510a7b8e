"""The tiny cells on the card (marker ``card``; each test skips without
one): a whole run through the flash kernels and the device trace.

    PYTHONPATH=src python -m pytest perfbench/tests -q -m card
"""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_bench
from perfbench import run


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("name", ["tiny-qwen3.prefill", "tiny-mixtral.prefill"])
def test_tiny_cells_on_the_card(tiny_root, name):
    _card()
    for trace in (False, True):
        cell = run.load_cell(tiny_bench(), name, seed=2 ** 31 + 5,
                             trace=trace, device="cuda", root=tiny_root)
        result, compared = run.run_cell(cell, 0.5, 0.0, tiny_root)
        assert result["correct"], compared
        if trace:
            assert result["device"]["busy_s"] > 0
            assert result["breakdown"]["device_ops"]
