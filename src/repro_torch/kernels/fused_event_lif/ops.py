"""Public wrappers of the fused event→LIF(→decode) kernels.

The port of ``repro.kernels.fused_event_lif.ops`` with the same signatures,
minus ``backend=``: the device of the tensors decides. On CUDA tensors a
wrapper launches its hand-written kernel (``csrc/fused_event_lif.cu``,
built with nvcc on first use) or raises; on CPU tensors it runs the plain
PyTorch version in ``ref``. There is no fallback from one to the other.

Each wrapper counts its kernel launches in ``LAUNCHES`` (only where the
kernel is launched, never on the CPU path), so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lif_dynamics import LIFResult
from repro_torch.kernels import build
from repro_torch.kernels.common import P, I, check_tensors, raise_on, stream
from repro_torch.kernels.fused_event_lif import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"fused_event_lif": 0, "fused_event_lif_decode": 0,
            "fused_event_lif_early_exit": 0}

_SOURCE = "fused_event_lif"
#: widest padded layer the kernels take (512 threads x 8 lanes per thread)
MAX_N_PAD = 4096


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    lib.fused_event_lif.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.fused_event_lif_decode.argtypes = [P] * 7 + [I] * 9 + [P]
    lib.fused_event_lif_early_exit.argtypes = [P] * 7 + [I] * 6 + [P]
    for fn in (lib.fused_event_lif, lib.fused_event_lif_decode,
               lib.fused_event_lif_early_exit):
        fn.restype = I
    return lib


def _check(ids: torch.Tensor, count: torch.Tensor, w: torch.Tensor,
           thresholds: torch.Tensor, leak_shift: int) -> None:
    """Shapes, dtypes, one device, contiguity: what the kernel assumes."""
    if ids.dim() != 3 or count.shape != ids.shape[:2]:
        raise ValueError(f"ids must be (B, T, E_max) and count (B, T); got "
                         f"{tuple(ids.shape)} and {tuple(count.shape)}")
    if w.dim() != 2 or thresholds.shape != (w.shape[1],):
        raise ValueError(f"w must be (N_in, N_pad) and thresholds (N_pad,); "
                         f"got {tuple(w.shape)} and {tuple(thresholds.shape)}")
    check_tensors(ids.device, ids=(ids, torch.int32),
                  count=(count, torch.int32), w=(w, torch.int8),
                  thresholds=(thresholds, torch.int32))
    for name, t in (("ids", ids), ("count", count), ("w", w),
                    ("thresholds", thresholds)):
        if ids.is_cuda and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= int(leak_shift) <= 31:
        raise ValueError(f"leak_shift={leak_shift} is not in 0..31")
    if ids.is_cuda and w.shape[1] > MAX_N_PAD:
        raise ValueError(f"N_pad={w.shape[1]} > {MAX_N_PAD}, the widest "
                         f"layer the CUDA kernels take")


def fused_event_lif(ids: torch.Tensor, count: torch.Tensor, w: torch.Tensor,
                    thresholds: torch.Tensor, leak_shift: int) -> LIFResult:
    """Full-T fused pass, no decode. ids (B, T, E_max) int32 (PAD = -1),
    count (B, T) int32, w (N_in, N_pad) int8, thresholds (N_pad,) int32 ->
    LIFResult over (B, N_pad)."""
    _check(ids, count, w, thresholds, leak_shift)
    if not ids.is_cuda:
        first, v = _ref.fused_event_lif_ref(ids, count, w, thresholds,
                                            leak_shift)
        return LIFResult(first_spike=first, v_final=v)
    B, T, E = ids.shape
    n_in, n_pad = w.shape
    first = torch.empty((B, n_pad), dtype=torch.int32, device=ids.device)
    v = torch.empty_like(first)
    if B:
        with torch.cuda.device(ids.device):
            code = _lib().fused_event_lif(
                ids.data_ptr(), count.data_ptr(), w.data_ptr(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(), B, T,
                E, n_in, n_pad, int(leak_shift), stream(ids))
        raise_on(code, "fused_event_lif")
        LAUNCHES["fused_event_lif"] += 1
    return LIFResult(first_spike=first, v_final=v)


def fused_event_lif_decode(ids: torch.Tensor, count: torch.Tensor,
                           w: torch.Tensor, thresholds: torch.Tensor,
                           leak_shift: int, *, n_out: int, n_groups: int,
                           per_group: int, fallback: str = "membrane"
                           ) -> tuple[LIFResult, torch.Tensor]:
    """Full-T megakernel with the grouped-TTFS comparator fused after the
    T-loop. ids (B, T, E_max) int32 (PAD = -1), count (B, T) int32,
    w (N_in, N_pad) int8, thresholds (N_pad,) int32 ->
    (LIFResult over (B, N_pad), labels (B,) int32)."""
    _check(ids, count, w, thresholds, leak_shift)
    if n_out > w.shape[1] or n_out != n_groups * per_group:
        raise ValueError(f"n_out={n_out} must equal n_groups*per_group and "
                         f"fit in N_pad={w.shape[1]}")
    if fallback not in ("membrane", "zero"):
        raise ValueError(f"unknown fallback {fallback!r}")
    if not ids.is_cuda:
        first, v, labels = _ref.fused_event_lif_decode_ref(
            ids, count, w, thresholds, leak_shift, n_out=n_out,
            n_groups=n_groups, per_group=per_group, fallback=fallback)
        return LIFResult(first_spike=first, v_final=v), labels
    B, T, E = ids.shape
    n_in, n_pad = w.shape
    first = torch.empty((B, n_pad), dtype=torch.int32, device=ids.device)
    v = torch.empty_like(first)
    labels = torch.empty((B,), dtype=torch.int32, device=ids.device)
    if B:
        with torch.cuda.device(ids.device):
            code = _lib().fused_event_lif_decode(
                ids.data_ptr(), count.data_ptr(), w.data_ptr(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(),
                labels.data_ptr(), B, T, E, n_in, n_pad, int(leak_shift),
                n_out, per_group, int(fallback == "membrane"), stream(ids))
        raise_on(code, "fused_event_lif_decode")
        LAUNCHES["fused_event_lif_decode"] += 1
    return LIFResult(first_spike=first, v_final=v), labels


def fused_event_lif_early_exit(ids: torch.Tensor, count: torch.Tensor,
                               w: torch.Tensor, thresholds: torch.Tensor,
                               leak_shift: int
                               ) -> tuple[LIFResult, torch.Tensor]:
    """Latency mode: each row stops at its first output spike. Returns
    (LIFResult with v at exit, steps (B,) int32)."""
    _check(ids, count, w, thresholds, leak_shift)
    if not ids.is_cuda:
        first, v, steps = _ref.fused_event_lif_early_exit_ref(
            ids, count, w, thresholds, leak_shift)
        return LIFResult(first_spike=first, v_final=v), steps
    B, T, E = ids.shape
    n_in, n_pad = w.shape
    first = torch.empty((B, n_pad), dtype=torch.int32, device=ids.device)
    v = torch.empty_like(first)
    steps = torch.empty((B,), dtype=torch.int32, device=ids.device)
    if B:
        with torch.cuda.device(ids.device):
            code = _lib().fused_event_lif_early_exit(
                ids.data_ptr(), count.data_ptr(), w.data_ptr(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(),
                steps.data_ptr(), B, T, E, n_in, n_pad, int(leak_shift),
                stream(ids))
        raise_on(code, "fused_event_lif_early_exit")
        LAUNCHES["fused_event_lif_early_exit"] += 1
    return LIFResult(first_spike=first, v_final=v), steps
