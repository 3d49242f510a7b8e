"""Public wrapper of the flash-attention kernels.

The port of ``repro.kernels.flash_attention.ops.flash_attention`` with its
signature, plus ``kv_len`` (keys at or past it are masked), which the Pallas
kernel takes. On CUDA tensors it launches one of two hand-written kernels,
built with nvcc on first use, or raises; on CPU tensors it runs the plain
version in ``ref``. ``route`` picks the kernel from the inputs' dtype, head
size, strides and alignment before the launch, and nothing falls back from
one kernel to the other:

* ``flash_attention_sm90`` (``csrc/flash_attention_sm90.cu``): bf16 with
  D in {64, 128} and inputs a TMA tensor map can describe (d stride 1, every
  other stride a multiple of 16 bytes, 16-byte aligned pointers): wgmma on
  the tensor cores, TMA loads.
* ``flash_attention`` (``csrc/flash_attention.cu``): everything else it
  takes, float32 among it: wgmma on the tensor cores in split TF32 (each
  operand as hi + lo, three products a multiply-add). Float32's 2e-5
  tolerance rules out single TF32, not split TF32.

There is no padding: the kernels mask ragged Sq and Skv themselves. Both
read q, k and v through their strides and write an output with q's strides
(``torch.empty_like``), so the model's (B, S, H, D) projections viewed as
(B, H, S, D) by ``movedim`` are read in place and the output comes back in
the same layout: no copy either way. ``LAUNCHES`` counts each kernel's
launches under its own name.

Training goes through ``FlashAttention``, an autograd Function: its forward
is ``flash_attention``, its backward ``flash_attention_bwd``, which on CUDA
tensors launches the hand-written ``csrc/flash_attention_bwd.cu`` (float32
and bf16, D a multiple of 8 up to 256, the forward's strides and masks) or
raises, and on CPU tensors runs ``ref.flash_attention_bwd_ref``. The TPU
package has no Pallas backward: JAX differentiates the jnp
``chunked_attention`` (``src/repro/models/layers.py:57``), so this kernel
replaces no TPU kernel; it is what lets the port train on the card without
a plain version on the path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (P, I, L, count_launch, on_device,
                                        raise_on, stream)
from repro_torch.kernels.flash_attention import ref as _ref

SM90 = "flash_attention_sm90"
SPLIT_TF32 = "flash_attention"
BWD = "flash_attention_bwd"
#: kernel name -> launches since the last ``reset_launches()`` (the
#: backward's two passes are one launch of its C entry)
LAUNCHES = {SPLIT_TF32: 0, SM90: 0, BWD: 0}
#: the input types the split-TF32 kernel takes, and the code its C entry reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head sizes the tensor-core kernel is built for
SM90_HEAD_DIMS = (64, 128)
#: TMA's alignment of every stride but the innermost, and of the base
TMA_ALIGN = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tma_legal(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map can describe ``t`` (B, H, S, D) as it lies:
    d stride 1, the other strides multiples of 16 bytes, the first element
    16-byte aligned."""
    e = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % TMA_ALIGN == 0
            and all(s * e % TMA_ALIGN == 0 for s in t.stride()[:3]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these inputs: ``SM90`` for bf16 with D in
    ``SM90_HEAD_DIMS`` and TMA-legal q, k and v, else ``SPLIT_TF32``. A pure
    function of dtype, head size, strides and alignment."""
    if q.dtype == torch.bfloat16 and q.shape[3] in SM90_HEAD_DIMS and \
            all(tma_legal(t) for t in (q, k, v)):
        return SM90
    return SPLIT_TF32


def tma_geometry(t: torch.Tensor) -> tuple[int, ...]:
    """The tensor map's view of ``t`` (B, H, S, D): its dims innermost first
    (D, S, H, B), then the byte strides of S, H and B."""
    B, H, S, D = t.shape
    e = t.element_size()
    return (D, S, H, B, t.stride(2) * e, t.stride(1) * e, t.stride(0) * e)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SPLIT_TF32)
    lib.flash_attention.argtypes = ([P] + [L] * 4) * 4 + [I] * 11 + [P]
    lib.flash_attention.restype = I
    return lib


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = build.load(SM90)
    lib.flash_attention_sm90.argtypes = [P] * 5 + [L] * 3 + [I] * 10 + [P]
    lib.flash_attention_sm90.restype = I
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = build.load(BWD)
    lib.flash_attention_bwd.argtypes = ([P] + [L] * 4) * 8 + [P, P] + \
        [I] * 11 + [P]
    lib.flash_attention_bwd.restype = I
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
    name = route(q, k, v)
    if name == SPLIT_TF32 and (D % 8 or not 8 <= D <= 256):
        raise ValueError(f"the kernel takes a head size D that is a multiple "
                         f"of 8 up to 256; got {D}")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    mask = (int(causal), 0 if window is None else int(window), int(q_offset),
            Skv if kv_len is None else int(kv_len))
    with on_device(q):
        if name == SM90:
            geo = (ctypes.c_ulonglong * 21)(
                *(g for t in (q, k, v) for g in tma_geometry(t)))
            code = _lib_sm90().flash_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geo,
                *out.stride()[:3], B, Hq, Hkv, Sq, Skv, D, *mask, stream(q))
        else:
            code = _lib().flash_attention(
                q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
                v.data_ptr(), *v.stride(), out.data_ptr(), *out.stride(),
                B, Hq, Hkv, Sq, Skv, D, *mask, DTYPES[q.dtype], stream(q))
    raise_on(code, name)
    count_launch(LAUNCHES, name)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0, kv_len: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)``,
    whose output was ``out``, against ``dout``: each in its input's dtype
    and strides. Every tensor is read through its strides (the model's
    ``movedim`` views in place)."""
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be q's shape {tuple(q.shape)}; "
                         f"got {tuple(out.shape)} and {tuple(dout.shape)}")
    if any(t.dtype != q.dtype or t.device != q.device
           for t in (k, v, out, dout)):
        raise TypeError("q, k, v, out and dout must share one dtype and "
                        "device")
    if q.dtype not in DTYPES:
        raise TypeError(f"the backward takes float32 or bfloat16; got "
                        f"{q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or at least 1")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not q.is_cuda:
        return _ref.flash_attention_bwd_ref(
            q, k, v, out, dout, causal=causal, window=window,
            q_offset=q_offset, kv_len=kv_len)
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"the backward kernel takes a head size D that is a "
                         f"multiple of 8 up to 256; got {D}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not q.numel():
        return dq, dk.zero_(), dv.zero_()
    # the row statistics pass 1 leaves for pass 2: log-sum-exp, rowsum(dO O)
    stats = torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=q.device)
    mask = (int(causal), 0 if window is None else int(window), int(q_offset),
            Skv if kv_len is None else int(kv_len))
    with on_device(q):
        code = _lib_bwd().flash_attention_bwd(
            *(x for t in (q, k, v, out, dout, dq, dk, dv)
              for x in (t.data_ptr(), *t.stride())),
            stats[0].data_ptr(), stats[1].data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, *mask, DTYPES[q.dtype], stream(q))
    raise_on(code, BWD)
    count_launch(LAUNCHES, BWD)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is the wrapper above
    (a kernel on the card, the plain version on the CPU), the backward
    ``flash_attention_bwd`` on the saved q, k, v and output. The forward is
    looked up in this module when it runs, so a caller may stand another
    attention in for it (``chip_smoke.py`` does, to record or compare)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, q_offset=0,
                kv_len=None):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, **ctx.mask)
        return dq, dk, dv, None, None, None, None

