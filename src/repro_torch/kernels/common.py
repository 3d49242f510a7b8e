"""Plumbing the kernel wrappers share: the ctypes argument types, the stream
a launch goes on, the check of a C entry point's return code, and the
dtype/device checks every wrapper makes before it dispatches."""

from __future__ import annotations

import ctypes

import torch

#: ctypes types of a pointer (and of the stream), an int and an int64
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error (its launch was
    refused, or its arguments were)."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {code}")


def check_tensors(device: torch.device, **tensors) -> None:
    """``name=(tensor, dtype)``: each has its dtype and lies on ``device``."""
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
