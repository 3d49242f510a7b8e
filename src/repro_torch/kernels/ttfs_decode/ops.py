"""Public wrapper of the grouped-TTFS decode kernel.

The port of ``repro.kernels.ttfs_decode.ops.ttfs_decode`` with its
signature. On CUDA tensors it launches the hand-written kernel
(``csrc/ttfs_decode.cu``, built with nvcc on first use) or raises; on CPU
tensors it runs the plain version in ``ref``. Rows are read through their
stride, so ``first[:, :n_out]`` of a (B, N_pad) tensor is decoded in place.

``LAUNCHES`` counts the kernel's launches; ``ROUTES`` counts them again by
how many threads decode a row: ``"warp"`` (a warp a row, for rows of at most
``WARP_MAX_N`` lanes, as at every serving shape) or ``"block"`` (a block a
row, the wide layers). ``route`` says which a launch takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, L, check_tensors, count_launch,
                                        on_device, raise_on, stream)
from repro_torch.kernels.ttfs_decode import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"ttfs_decode": 0}
#: the same launches by how many threads decode a row
ROUTES = {"warp": 0, "block": 0}
#: the widest row a single warp decodes; wider rows take a block each
WARP_MAX_N = 1024


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ttfs_decode")
    lib.ttfs_decode.argtypes = [P] * 2 + [L] * 2 + [P] + [I] * 6 + [P]
    lib.ttfs_decode.restype = I
    return lib


def route(n: int) -> str:
    """How the kernel decodes rows of ``n`` lanes: "warp" (a warp a row) up
    to ``WARP_MAX_N``, else "block" (a block a row)."""
    return "warp" if n <= WARP_MAX_N else "block"


def ttfs_decode(first_spike: torch.Tensor, v_final: torch.Tensor, *,
                n_groups: int, per_group: int, sentinel: int,
                fallback: str = "membrane") -> torch.Tensor:
    """first_spike, v_final (B, G*P) int32 (each row contiguous, rows at any
    stride) -> labels (B,) int32."""
    n = n_groups * per_group
    if first_spike.dim() != 2 or v_final.shape != first_spike.shape or \
            first_spike.shape[1] != n or n_groups < 1 or per_group < 1:
        raise ValueError(f"first_spike and v_final must both be (B, "
                         f"n_groups*per_group = {n}); got "
                         f"{tuple(first_spike.shape)} and "
                         f"{tuple(v_final.shape)}")
    if fallback not in ("membrane", "zero"):
        raise ValueError(f"unknown fallback {fallback!r}")
    check_tensors(first_spike.device, first_spike=(first_spike, torch.int32),
                  v_final=(v_final, torch.int32))
    if not first_spike.is_cuda:
        return _ref.ttfs_decode_ref(first_spike, v_final, n_groups=n_groups,
                                    per_group=per_group, sentinel=sentinel,
                                    fallback=fallback)
    if first_spike.stride(1) != 1 or v_final.stride(1) != 1:
        raise ValueError("each row of first_spike and v_final must be "
                         "contiguous")
    B = first_spike.shape[0]
    labels = first_spike.new_empty((B,))
    if B:
        how = route(n)
        with on_device(first_spike):
            code = _lib().ttfs_decode(
                first_spike.data_ptr(), v_final.data_ptr(),
                first_spike.stride(0), v_final.stride(0), labels.data_ptr(),
                B, n_groups, per_group, int(sentinel),
                int(fallback == "membrane"), int(how == "block"),
                stream(first_spike))
        raise_on(code, "ttfs_decode")
        count_launch(LAUNCHES, "ttfs_decode")
        count_launch(ROUTES, how)
    return labels
