"""Plumbing the kernel wrappers share: the ctypes argument types, the device
and the stream a launch goes on, the check of a C entry point's return code,
and the dtype/device checks every wrapper makes before it dispatches.

A wrapper pays this host work on every launch, so the two lookups take the
short way where there is one: ``on_device`` makes no device switch when the
tensor's card is already the current one, and ``stream`` reads the current
stream's handle without building a ``torch.cuda.Stream``. ``count_launch``
adds a launch to a wrapper's counters under one lock, so serving lanes that
launch from several threads at once lose no count.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

#: ctypes types of a pointer (and of the stream), an int and an int64
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


_NO_SWITCH = contextlib.nullcontext()
_COUNT_LOCK = threading.Lock()
#: the kernels package: a frame of one of its modules means an exception
#: passed through a wrapper, a build or a plain version
_KERNELS_PKG = __name__.rpartition(".")[0] + "."
#: what the CUDA runtime and the caching allocator raise
_CUDA_ERRORS = (torch.AcceleratorError, torch.OutOfMemoryError)


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched."""


def kernel_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a failure of the kernels or of the card, not a
    fault of a serving lane: a ``KernelError``, an error of the CUDA runtime
    or of the caching allocator, or anything raised inside this package (a
    wrapper's checks or launch, a build, a plain version). An injected or
    modelled fault, a detector's finding and a watchdog timeout are lane
    faults; these are not, and the serving tier lets them propagate rather
    than rebuild or degrade a lane around them."""
    if isinstance(exc, (KernelError, *_CUDA_ERRORS)):
        return True
    tb = exc.__traceback__
    while tb is not None:
        if tb.tb_frame.f_globals.get("__name__", "").startswith(_KERNELS_PKG):
            return True
        tb = tb.tb_next
    return exc.__cause__ is not None and kernel_failure(exc.__cause__)


def count_launch(counts: dict[str, int], name: str) -> None:
    """``counts[name] += 1`` under one process-wide lock: the ``+=`` on a
    dict entry is a read-modify-write that two threads may interleave."""
    with _COUNT_LOCK:
        counts[name] += 1


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
        raise KernelError(f"{kernel} launch failed with CUDA error {code}")


def check_tensors(device: torch.device, **tensors) -> None:
    """``name=(tensor, dtype)``: each has its dtype and lies on ``device``."""
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
