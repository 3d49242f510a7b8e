"""Plain PyTorch version of the LIF-scan kernel.

The semantics of the Pallas kernel it replaces (``repro/kernels/lif/
kernel.py``) and of ``csrc/lif.cu``: the integer LIF recurrence of
``core.lif_dynamics`` over T steps of precomputed currents, with the
first-spike latch, in the scan layout (T, B, N_pad).
"""

from __future__ import annotations

import torch

from repro_torch.core.lif_dynamics import LIFResult, lif_scan


def lif_fused_ref(currents: torch.Tensor, thresholds: torch.Tensor,
                  leak_shift: int) -> LIFResult:
    """currents (T, B, N_pad) int32 -> LIFResult over (B, N_pad)."""
    return lif_scan(currents, thresholds, leak_shift, currents.shape[0])
