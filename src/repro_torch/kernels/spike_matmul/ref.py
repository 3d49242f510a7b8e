"""Plain PyTorch version of the exact int8 matrix-product kernel.

The semantics of the Pallas kernel it replaces (``repro/kernels/
spike_matmul/kernel.py``, int32 accumulation, which wraps as XLA's int32
``dot_general`` does) and of ``csrc/spike_matmul.cu``. PyTorch has no
int32-accumulating int8 product on the card (``int8 @ int8`` wraps to
int8), so this version multiplies in float64: every product and partial sum
is an integer of magnitude at most 128 * 128 * K, exact in float64 while
that stays below 2**53 (K below 5.4e11). The exact sum is then wrapped to
int32 two's complement, which is what an int32 accumulation gives at any K.
"""

from __future__ import annotations

import torch


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32, two's complement."""
    low = torch.bitwise_and(x, 0xFFFFFFFF)
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)


def spike_matmul_ref(raster: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """raster (..., K) int8, w (K, N) int8 -> (..., N) int32."""
    exact = torch.matmul(raster.to(torch.float64), w.to(torch.float64))
    return wrap_int32(exact.to(torch.int64))
