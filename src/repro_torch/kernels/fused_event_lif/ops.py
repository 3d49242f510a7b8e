"""Public wrappers of the fused event→LIF(→decode) kernels.

The port of ``repro.kernels.fused_event_lif.ops`` with the same signatures,
minus ``backend=``: the device of the tensors decides. On CUDA tensors a
wrapper launches its hand-written kernel (``csrc/fused_event_lif.cu``,
built with nvcc on first use) or raises; on CPU tensors it runs the plain
PyTorch version in ``ref``. There is no fallback from one to the other.

Each wrapper counts its kernel launches in ``LAUNCHES`` (only where the
kernel is launched, never on the CPU path), so a run can show that its main
path went through the kernels. ``launch_plan`` picks each launch's block
shape, chunk of steps and, for rows wider than 4096 lanes, the thread-block
cluster that splits a row, on the host (cached per shape); a plan the
kernel cannot run raises ``ValueError`` before the launch. The widest row
the kernels take is ``MAX_N_PAD`` (32,768) lanes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.lif_dynamics import LIFResult
from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, check_tensors, count_launch,
                                        on_device, raise_on, stream)
from repro_torch.kernels.fused_event_lif import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"fused_event_lif": 0, "fused_event_lif_decode": 0,
            "fused_event_lif_early_exit": 0}

_SOURCE = "fused_event_lif"
#: lanes one block scans (512 threads x 8 lanes per thread)
MAX_SLICE = 4096
#: blocks a row may take (a portable thread-block cluster)
MAX_CLUSTER = 8
#: widest padded layer the kernels take: a cluster of 8 blocks of 4096 lanes
MAX_N_PAD = MAX_CLUSTER * MAX_SLICE
#: threads a block (the kernels' __launch_bounds__)
MAX_THREADS = 512
#: shared memory one H100 block may hold (227 KB), and what a plan may take
#: of it for the chunk's currents: 1 KB stays for the decode reduction
SMEM_PER_BLOCK = 232_448
MAX_CUR_BYTES = SMEM_PER_BLOCK - 1024


class LaunchPlan(NamedTuple):
    """One launch of the fused kernels: ``cluster`` blocks of ``threads``
    per batch row (a thread-block cluster when more than 1), each owning a
    slice of the row's lanes (``slice_lanes``) and scanning
    ``lanes_per_thread`` of them a thread; the row's steps gathered
    ``chunk`` at a time into ``smem_bytes`` of shared memory a block."""
    threads: int
    lanes_per_thread: int
    chunk: int
    smem_bytes: int
    cluster: int = 1


def _cols_per_lane(n_pad: int) -> int:
    """int8 columns one gathering lane owns (csrc: ``cols_per_lane``)."""
    return 4 if n_pad <= 128 else 8 if n_pad <= 256 else 16


def slice_lanes(n_pad: int, cluster: int) -> int:
    """Lanes each block of a row's cluster owns (csrc: ``slice_lanes``): the
    whole row for one block, else an even share rounded up to 16 (the last
    block's slice is shorter)."""
    if cluster == 1:
        return n_pad
    return (-(-n_pad // cluster) + 15) // 16 * 16


def _warps_per_step(n_pad: int, cluster: int = 1) -> int:
    return -(-slice_lanes(n_pad, cluster) // (32 * _cols_per_lane(n_pad)))


@functools.cache
def launch_plan(T: int, e_max: int, n_pad: int,
                max_chunk: int | None = None) -> LaunchPlan:
    """The plan for rows of ``T`` steps, ``e_max`` slots a step and ``n_pad``
    lanes: one block a row up to 4096 lanes, else the smallest cluster of
    2, 4 or 8 blocks whose slices hold 4096 lanes at most; the longest chunk
    of steps (at most ``max_chunk``) whose int32 currents of a slice fit in
    shared memory, and enough warps to gather every step of a chunk at once
    (one warp per 128, 256 or 512 columns of a step), up to 512 threads."""
    if T < 1 or e_max < 1:
        raise ValueError(f"T={T} and E_max={e_max} must be at least 1")
    if not 1 <= n_pad <= MAX_N_PAD:
        raise ValueError(f"N_pad={n_pad} is not in 1..{MAX_N_PAD}, the widths "
                         f"the CUDA kernels take (a cluster of {MAX_CLUSTER} "
                         f"blocks of {MAX_SLICE} lanes)")
    if max_chunk is not None and max_chunk < 1:
        raise ValueError(f"max_chunk={max_chunk} must be at least 1")
    cluster = 1
    while cluster * MAX_SLICE < n_pad:
        cluster *= 2
    width = slice_lanes(n_pad, cluster)
    chunk = min(T, max_chunk or T, MAX_CUR_BYTES // (4 * width))
    lpt = 1
    while lpt * MAX_THREADS < width:
        lpt *= 2
    gather_warps = _warps_per_step(n_pad, cluster) * chunk
    scan_warps = -(-width // (32 * lpt))
    threads = 32 * min(MAX_THREADS // 32, max(gather_warps, scan_warps))
    return LaunchPlan(threads, lpt, chunk, 4 * chunk * width, cluster)


def check_plan(plan: LaunchPlan, T: int, e_max: int, n_pad: int) -> None:
    """Raise ``ValueError`` if the kernels cannot run ``plan``: the test the
    C entry points make before a launch (``fused_event_lif_plan_ok``, which
    chip_smoke.py holds to this one on the card)."""
    threads, lpt, chunk, smem, cluster = plan
    big = _cols_per_lane(n_pad) == 16
    ok = (T >= 1 and e_max >= 1 and 1 <= n_pad <= MAX_N_PAD
          and (cluster == 1 or (big and cluster in (2, 4, 8))))
    if ok:
        width = slice_lanes(n_pad, cluster)
        ok = (width <= MAX_SLICE and width * (cluster - 1) < n_pad
              and (lpt == 1 or (big and lpt in (2, 4, 8)))
              and threads % 32 == 0
              and 32 * _warps_per_step(n_pad, cluster) <= threads
              <= MAX_THREADS
              and lpt * threads >= width and 1 <= chunk <= T
              and smem == 4 * chunk * width <= MAX_CUR_BYTES)
    if not ok:
        raise ValueError(f"the fused kernels cannot run {plan} for T={T}, "
                         f"E_max={e_max}, N_pad={n_pad}")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    lib.fused_event_lif.argtypes = [P] * 6 + [I] * 11 + [P]
    lib.fused_event_lif_decode.argtypes = [P] * 7 + [I] * 14 + [P]
    lib.fused_event_lif_early_exit.argtypes = [P] * 7 + [I] * 11 + [P]
    lib.fused_event_lif_plan_ok.argtypes = [I] * 8
    lib.fused_event_lif_row_load_bytes.argtypes = [P, I]
    for fn in (lib.fused_event_lif, lib.fused_event_lif_decode,
               lib.fused_event_lif_early_exit, lib.fused_event_lif_plan_ok,
               lib.fused_event_lif_row_load_bytes):
        fn.restype = I
    return lib


def _check(ids: torch.Tensor, count: torch.Tensor, w: torch.Tensor,
           thresholds: torch.Tensor, leak_shift: int,
           plan: LaunchPlan | None) -> None:
    """Shapes, dtypes, one device, contiguity, a plan the kernel can run:
    what the kernel assumes."""
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
    if plan is not None:
        check_plan(plan, ids.shape[1], ids.shape[2], w.shape[1])


def fused_event_lif(ids: torch.Tensor, count: torch.Tensor, w: torch.Tensor,
                    thresholds: torch.Tensor, leak_shift: int, *,
                    plan: LaunchPlan | None = None) -> LIFResult:
    """Full-T fused pass, no decode. ids (B, T, E_max) int32 (PAD = -1),
    count (B, T) int32, w (N_in, N_pad) int8, thresholds (N_pad,) int32 ->
    LIFResult over (B, N_pad). ``plan`` replaces ``launch_plan``'s on the
    card (to measure another one); it is checked on either device."""
    _check(ids, count, w, thresholds, leak_shift, plan)
    if not ids.is_cuda:
        first, v = _ref.fused_event_lif_ref(ids, count, w, thresholds,
                                            leak_shift)
        return LIFResult(first_spike=first, v_final=v)
    B, T, E = ids.shape
    n_in, n_pad = w.shape
    plan = plan or launch_plan(T, E, n_pad)
    first = torch.empty((B, n_pad), dtype=torch.int32, device=ids.device)
    v = torch.empty_like(first)
    if B:
        with on_device(ids):
            code = _lib().fused_event_lif(
                ids.data_ptr(), count.data_ptr(), w.data_ptr(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(), B, T,
                E, n_in, n_pad, int(leak_shift), *plan, stream(ids))
        raise_on(code, "fused_event_lif")
        count_launch(LAUNCHES, "fused_event_lif")
    return LIFResult(first_spike=first, v_final=v)


def fused_event_lif_decode(ids: torch.Tensor, count: torch.Tensor,
                           w: torch.Tensor, thresholds: torch.Tensor,
                           leak_shift: int, *, n_out: int, n_groups: int,
                           per_group: int, fallback: str = "membrane",
                           plan: LaunchPlan | None = None
                           ) -> tuple[LIFResult, torch.Tensor]:
    """Full-T megakernel with the grouped-TTFS comparator fused after the
    T-loop. ids (B, T, E_max) int32 (PAD = -1), count (B, T) int32,
    w (N_in, N_pad) int8, thresholds (N_pad,) int32 ->
    (LIFResult over (B, N_pad), labels (B,) int32). ``plan`` as in
    ``fused_event_lif``."""
    _check(ids, count, w, thresholds, leak_shift, plan)
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
    plan = plan or launch_plan(T, E, n_pad)
    first = torch.empty((B, n_pad), dtype=torch.int32, device=ids.device)
    v = torch.empty_like(first)
    labels = torch.empty((B,), dtype=torch.int32, device=ids.device)
    if B:
        with on_device(ids):
            code = _lib().fused_event_lif_decode(
                ids.data_ptr(), count.data_ptr(), w.data_ptr(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(),
                labels.data_ptr(), B, T, E, n_in, n_pad, int(leak_shift),
                n_out, per_group, int(fallback == "membrane"), *plan,
                stream(ids))
        raise_on(code, "fused_event_lif_decode")
        count_launch(LAUNCHES, "fused_event_lif_decode")
    return LIFResult(first_spike=first, v_final=v), labels


def fused_event_lif_early_exit(ids: torch.Tensor, count: torch.Tensor,
                               w: torch.Tensor, thresholds: torch.Tensor,
                               leak_shift: int, *,
                               plan: LaunchPlan | None = None
                               ) -> tuple[LIFResult, torch.Tensor]:
    """Latency mode: each row stops at its first output spike. Returns
    (LIFResult with v at exit, steps (B,) int32). ``plan`` as in
    ``fused_event_lif``."""
    _check(ids, count, w, thresholds, leak_shift, plan)
    if not ids.is_cuda:
        first, v, steps = _ref.fused_event_lif_early_exit_ref(
            ids, count, w, thresholds, leak_shift)
        return LIFResult(first_spike=first, v_final=v), steps
    B, T, E = ids.shape
    n_in, n_pad = w.shape
    plan = plan or launch_plan(T, E, n_pad)
    first = torch.empty((B, n_pad), dtype=torch.int32, device=ids.device)
    v = torch.empty_like(first)
    steps = torch.empty((B,), dtype=torch.int32, device=ids.device)
    if B:
        with on_device(ids):
            code = _lib().fused_event_lif_early_exit(
                ids.data_ptr(), count.data_ptr(), w.data_ptr(),
                thresholds.data_ptr(), first.data_ptr(), v.data_ptr(),
                steps.data_ptr(), B, T, E, n_in, n_pad, int(leak_shift),
                *plan, stream(ids))
        raise_on(code, "fused_event_lif_early_exit")
        count_launch(LAUNCHES, "fused_event_lif_early_exit")
    return LIFResult(first_spike=first, v_final=v), steps
