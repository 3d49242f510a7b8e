"""Public wrapper of the exact int8 matrix-product kernel.

The port of ``repro.kernels.spike_matmul.ops.spike_matmul`` with its
signature. On CUDA tensors it launches the hand-written kernel
(``csrc/spike_matmul.cu``, built with nvcc on first use) or raises; on CPU
tensors it runs the plain version in ``ref``. The kernel masks its own
ragged edges, so nothing is padded. ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, L, check_tensors, raise_on,
                                        stream)
from repro_torch.kernels.spike_matmul import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"spike_matmul": 0}

#: deepest product whose int32 sums cannot overflow (128 * 127 * K < 2**31)
MAX_K = 131_072


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("spike_matmul")
    lib.spike_matmul.argtypes = [P] * 3 + [L] + [I] * 2 + [P]
    lib.spike_matmul.restype = I
    return lib


def spike_matmul(raster: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """raster (..., K) int8 (the batch path's (B, T, N_in) spike raster;
    any int8), w (K, N) int8 -> (..., N) int32, exact."""
    if raster.dim() < 1 or w.dim() != 2 or raster.shape[-1] != w.shape[0]:
        raise ValueError(f"raster must be (..., K) and w (K, N); got "
                         f"{tuple(raster.shape)} and {tuple(w.shape)}")
    K, N = w.shape
    if not 1 <= K < MAX_K:
        raise ValueError(f"K={K} must be in 1..{MAX_K - 1}")
    check_tensors(raster.device, raster=(raster, torch.int8),
                  w=(w, torch.int8))
    if not raster.is_cuda:
        return _ref.spike_matmul_ref(raster, w)
    if not (raster.is_contiguous() and w.is_contiguous()):
        raise ValueError("raster and w must be contiguous")
    out = torch.empty(raster.shape[:-1] + (N,), dtype=torch.int32,
                      device=raster.device)
    M = raster.numel() // K
    if M and N:
        with torch.cuda.device(raster.device):
            code = _lib().spike_matmul(raster.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), M, K, N,
                                       stream(raster))
        raise_on(code, "spike_matmul")
        LAUNCHES["spike_matmul"] += 1
    return out
