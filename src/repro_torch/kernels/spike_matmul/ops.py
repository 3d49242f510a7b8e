"""Public wrapper of the exact int8 matrix-product kernel.

The port of ``repro.kernels.spike_matmul.ops.spike_matmul`` with its
signature, plus the weights' K-major copy the tensor cores read. On CUDA
tensors it launches the hand-written kernel (``csrc/spike_matmul.cu``,
built with nvcc on first use) or raises; on CPU tensors it runs the plain
version in ``ref``. The kernel masks its own ragged edges, so nothing is
padded, and it takes any K (the int32 sums wrap, as XLA's do).

``LAUNCHES`` counts the kernel's launches; ``ROUTES`` counts them again by
how the kernel fills its tiles: ``"tma"`` (tensor copies, for rows whose
byte length is a multiple of 16 on 16-byte aligned data, as at every
serving shape) or ``"masked"`` (predicated loads, every other K or
alignment). ``route`` says which a launch takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, L, check_tensors, count_launch,
                                        on_device, raise_on, stream)
from repro_torch.kernels.spike_matmul import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"spike_matmul": 0}
#: the same launches by how the kernel filled its tiles
ROUTES = {"tma": 0, "masked": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("spike_matmul")
    lib.spike_matmul.argtypes = [P] * 3 + [L] + [I] * 3 + [P]
    lib.spike_matmul.restype = I
    return lib


def k_major(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights -> their (N, K) K-major copy, which the kernel reads."""
    return w.t().contiguous()


def route(raster: torch.Tensor, w_t: torch.Tensor) -> str:
    """How the kernel fills its tiles for these operands (the C entry's
    ``tma_ok``, which refuses "tma" otherwise): "tma" where a tensor map
    describes both, else "masked"."""
    K = w_t.shape[-1]
    aligned = raster.data_ptr() % 16 == 0 and w_t.data_ptr() % 16 == 0
    return "tma" if K % 16 == 0 and aligned else "masked"


def spike_matmul(raster: torch.Tensor, w: torch.Tensor, *,
                 w_t: torch.Tensor | None = None) -> torch.Tensor:
    """raster (..., K) int8 (the batch path's (B, T, N_in) spike raster;
    any int8), w (K, N) int8 -> (..., N) int32, exact modulo 2**32.

    ``w_t`` is ``k_major(w)``, the copy the kernel reads; a caller that
    multiplies by the same weights again keeps it (the accelerator keeps one
    per program), else the wrapper makes it on each call on the card."""
    if raster.dim() < 1 or w.dim() != 2 or raster.shape[-1] != w.shape[0]:
        raise ValueError(f"raster must be (..., K) and w (K, N); got "
                         f"{tuple(raster.shape)} and {tuple(w.shape)}")
    K, N = w.shape
    if K < 1:
        raise ValueError(f"K={K} must be at least 1")
    check_tensors(raster.device, raster=(raster, torch.int8),
                  w=(w, torch.int8))
    if w_t is not None:
        check_tensors(raster.device, w_t=(w_t, torch.int8))
        if w_t.shape != (N, K) or not w_t.is_contiguous():
            raise ValueError(f"w_t must be the contiguous (N, K) = {(N, K)} "
                             f"copy of w; got {tuple(w_t.shape)}")
    if not raster.is_cuda:
        return _ref.spike_matmul_ref(raster, w)
    if not (raster.is_contiguous() and w.is_contiguous()):
        raise ValueError("raster and w must be contiguous")
    M = raster.numel() // K
    if M >= 2 ** 31:
        raise ValueError(f"M={M} rows must be below 2**31")
    out = torch.empty(raster.shape[:-1] + (N,), dtype=torch.int32,
                      device=raster.device)
    if M and N:
        if w_t is None:
            w_t = k_major(w)
        how = route(raster, w_t)
        with on_device(raster):
            code = _lib().spike_matmul(raster.data_ptr(), w_t.data_ptr(),
                                       out.data_ptr(), M, K, N,
                                       int(how == "tma"), stream(raster))
        raise_on(code, "spike_matmul")
        count_launch(LAUNCHES, "spike_matmul")
        count_launch(ROUTES, how)
    return out
