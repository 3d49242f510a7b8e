"""Plain PyTorch version of the exact int8 matrix-product kernel.

The semantics of the Pallas kernel it replaces (``repro/kernels/
spike_matmul/kernel.py``, int32 accumulation) and of ``csrc/
spike_matmul.cu``. PyTorch has no int32-accumulating int8 product on the
card (``int8 @ int8`` wraps to int8), so this version multiplies in
float64: every product and partial sum is an integer of magnitude at most
128 * 127 * K, exact in float64 (below 2**53), and the int32 result equals
the int32 accumulation while that stays below 2**31 (K < 131,072).
"""

from __future__ import annotations

import torch


def spike_matmul_ref(raster: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """raster (..., K) int8, w (K, N) int8 -> (..., N) int32."""
    return torch.matmul(raster.to(torch.float64),
                        w.to(torch.float64)).to(torch.int32)
