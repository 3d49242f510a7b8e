"""Plumbing the kernel wrappers share: the ctypes argument types, the device
and the stream a launch goes on, the check of a C entry point's return code,
and the dtype/device checks every wrapper makes before it dispatches.

A wrapper pays this host work on every launch, so the two lookups take the
short way where there is one: ``on_device`` makes no device switch when the
tensor's card is already the current one, and ``stream`` reads the current
stream's handle without building a ``torch.cuda.Stream``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

#: ctypes types of a pointer (and of the stream), an int and an int64
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


_NO_SWITCH = contextlib.nullcontext()


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry takes it:
    the raw handle, read the short way PyTorch's generated kernels use."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(t: torch.Tensor) -> contextlib.AbstractContextManager:
    """The context to launch on ``t``'s card in: none when that card is
    already the current device, else ``torch.cuda.device`` (a launch goes to
    the current device, whatever stream it names)."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(index)


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
