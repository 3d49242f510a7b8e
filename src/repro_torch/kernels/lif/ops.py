"""Public wrapper of the LIF-scan kernel.

The port of ``repro.kernels.lif.ops.lif_fused`` with its signature: currents
in the scan layout (T, B, N_pad). On CUDA tensors it launches the
hand-written kernel (``csrc/lif.cu``, built with nvcc on first use) or
raises; on CPU tensors it runs the plain version in ``ref``. The kernel
reads the currents through their strides, so a (B, T, N_pad) tensor viewed
as (T, B, N_pad) by ``movedim`` is read in place, never copied.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lif_dynamics import LIFResult
from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, L, check_tensors, count_launch,
                                        on_device, raise_on, stream)
from repro_torch.kernels.lif import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"lif_fused": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lif")
    lib.lif_fused.argtypes = [P] + [L] * 3 + [P] * 3 + [I] * 4 + [P]
    lib.lif_fused.restype = I
    return lib


def lif_fused(currents: torch.Tensor, thresholds: torch.Tensor,
              leak_shift: int) -> LIFResult:
    """currents (T, B, N_pad) int32, any strides; thresholds (N_pad,) int32
    -> LIFResult over (B, N_pad)."""
    if currents.dim() != 3 or thresholds.shape != currents.shape[2:]:
        raise ValueError(f"currents must be (T, B, N_pad) and thresholds "
                         f"(N_pad,); got {tuple(currents.shape)} and "
                         f"{tuple(thresholds.shape)}")
    check_tensors(currents.device, currents=(currents, torch.int32),
                  thresholds=(thresholds, torch.int32))
    if not 0 <= int(leak_shift) <= 31:
        raise ValueError(f"leak_shift={leak_shift} is not in 0..31")
    if not currents.is_cuda:
        return _ref.lif_fused_ref(currents, thresholds, leak_shift)
    if not thresholds.is_contiguous():
        raise ValueError("thresholds must be contiguous")
    T, B, n = currents.shape
    first = currents.new_empty((B, n))
    v = currents.new_empty((B, n))
    if B and n:
        with on_device(currents):
            code = _lib().lif_fused(
                currents.data_ptr(), *currents.stride(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(), B, T,
                n, int(leak_shift), stream(currents))
        raise_on(code, "lif_fused")
        count_launch(LAUNCHES, "lif_fused")
    return LIFResult(first_spike=first, v_final=v)
