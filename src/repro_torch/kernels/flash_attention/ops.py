"""Public wrapper of the flash-attention kernel.

The port of ``repro.kernels.flash_attention.ops.flash_attention`` with its
signature, plus ``kv_len`` (keys at or past it are masked), which the Pallas
kernel takes. On CUDA tensors it launches the hand-written kernel
(``csrc/flash_attention.cu``, built with nvcc on first use) or raises; on
CPU tensors it runs the plain version in ``ref``. There is no padding: the
kernel masks ragged Sq and Skv itself. It reads q, k and v through their
strides and writes an output with q's strides (``torch.empty_like``), so the
model's (B, S, H, D) projections viewed as (B, H, S, D) by ``movedim`` are
read in place and the output comes back in the same layout: no copy either
way. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import P, I, L, raise_on, stream
from repro_torch.kernels.flash_attention import ref as _ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"flash_attention": 0}
#: the input types the kernel takes, and the code its C entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = ([P] + [L] * 4) * 4 + [I] * 11 + [P]
    lib.flash_attention.restype = I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), float32 or bfloat16, any
    strides -> (B, Hq, Sq, D) in q's dtype and strides."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            k.shape[1] == 0 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) "
                         f"with Hkv dividing Hq; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must lie on one device; got "
                         f"{q.device}, {k.device} and {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or at least 1")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Skv == 0:
        raise ValueError("attention over no keys (Skv = 0) is undefined")
    if not q.is_cuda:
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, kv_len=kv_len)
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"the kernel takes a head size D that is a multiple "
                         f"of 8 up to 256; got {D}")
    out = torch.empty_like(q)
    if out.numel():
        with torch.cuda.device(q.device):
            code = _lib().flash_attention(
                q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
                v.data_ptr(), *v.stride(), out.data_ptr(), *out.stride(),
                B, Hq, Hkv, Sq, Skv, D, int(causal),
                0 if window is None else int(window), int(q_offset),
                Skv if kv_len is None else int(kv_len), DTYPES[q.dtype],
                stream(q))
        raise_on(code, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
