"""Public wrapper of the event-accumulation kernel.

The port of ``repro.kernels.event_accum.ops.event_accum``: on CUDA tensors it
launches the hand-written kernel (``csrc/event_accum.cu``, built with nvcc on
first use) or raises; on CPU tensors it runs the plain version in ``ref``.
There is no fallback from one to the other. The kernel stages nothing per
row in shared memory, so a row may hold any number of event slots.
``LAUNCHES`` counts the kernel's launches (never the CPU path's calls).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, check_tensors, count_launch,
                                        on_device, raise_on, stream)
from repro_torch.kernels.event_accum import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"event_accum": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("event_accum")
    lib.event_accum.argtypes = [P] * 3 + [I] * 4 + [P]
    lib.event_accum.restype = I
    lib.event_accum_row_load_bytes.argtypes = [P, P, I]
    lib.event_accum_row_load_bytes.restype = I
    return lib


def event_accum(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ids (T, E_max) or (B, T, E_max) int32 (PAD = -1 in any slot),
    w (N_in, N_pad) int8 -> currents (T, N_pad) or (B, T, N_pad) int32.
    A served batch is one launch over all its B*T step rows."""
    if ids.dim() not in (2, 3) or w.dim() != 2:
        raise ValueError(f"ids must be (T, E_max) or (B, T, E_max) and w "
                         f"(N_in, N_pad); got {tuple(ids.shape)} and "
                         f"{tuple(w.shape)}")
    if ids.shape[-1] < 1:
        raise ValueError("ids must have at least one event slot")
    check_tensors(ids.device, ids=(ids, torch.int32), w=(w, torch.int8))
    if not ids.is_cuda:
        return _ref.event_accum_ref(ids, w)
    E = ids.shape[-1]
    n_in, n_pad = w.shape
    if not (ids.is_contiguous() and w.is_contiguous()):
        raise ValueError("ids and w must be contiguous")
    out = torch.empty(ids.shape[:-1] + (n_pad,), dtype=torch.int32,
                      device=ids.device)
    rows = ids.numel() // E
    if rows:
        with on_device(ids):
            code = _lib().event_accum(ids.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), rows, E, n_in, n_pad,
                                      stream(ids))
        raise_on(code, "event_accum")
        count_launch(LAUNCHES, "event_accum")
    return out
