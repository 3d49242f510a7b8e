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

With ``return_lse=True`` the forward also returns each row's statistic
``lse`` (B, Hq, Sq), float32: ``m + log2(l)`` in exp2's domain, the row's
log-sum-exp of ``q k^T / sqrt(D)`` over its visible keys times log2(e)
(scores scaled by ``scale_log2 = log2(e) / sqrt(D)``), +inf for a row that
sees no key. Both kernels write it from the running max and sum their
epilogue already holds; serving never asks for it, and the output is the
same either way.

Training goes through ``FlashAttention``, an autograd Function: its forward
is ``flash_attention`` asked for the statistic, its backward
``flash_attention_bwd``, which takes the statistic and on CUDA tensors
launches the hand-written ``csrc/flash_attention_bwd.cu`` (float32 and bf16,
D a multiple of 8 up to 256, the forward's strides and masks) or raises, and
on CPU tensors runs ``ref.flash_attention_bwd_ref``, which builds its own
softmax and reads no statistic. ``bwd_route`` picks the backward's route
from D before the launch (both input types take the same tiles):
split-TF32 wgmma on the tensor cores for D up to 128, the CUDA cores
above; ``BWD_ROUTES`` counts each launch again by route. The TPU package
has no Pallas backward: JAX differentiates the jnp ``chunked_attention``
(``src/repro/models/layers.py:57``), so this kernel replaces no TPU
kernel; it is what lets the port train on the card without a plain version
on the path.

Two more kinds of input reach the wrappers in the dry-run
(``launch/dryrun.py``), and neither is a fallback:

* A fake tensor (``FakeTensorMode``, any device) takes the kernels' fake
  path: the forward returns ``torch.empty_like(q)`` and, with
  ``return_lse``, the float32 (B, Hq, Sq) statistic, the backward dq, dk and
  dv and allocates its float32 (B, Hq, Sq) scratch, exactly what the kernels
  allocate. Nothing is launched or counted, no library is loaded, no
  ``data_ptr()`` is read and the plain version's (Sq x Skv) scores are never
  built, so the dry-run's memory is the kernels'.
* A ``DTensor`` runs locally under attention's sharding rule
  (``shard_rule``): q, k, v and the output are sharded alike over batch and
  over heads where the mesh dim divides Hkv; where it divides only Hq and
  a rank's query heads lie in one GQA group, k and v stay whole on that
  dim and each rank reads its group's KV head (the backward's dk, dv sum
  over the ranks that share it); every other placement is replicated
  first. Those redistributions are DTensor's, and its collective count
  sees them. The local call is this wrapper again, on the local shards.

Both checks read ``type(q)`` first, so a plain tensor pays one comparison.
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
#: the backward's launches again, by route (``bwd_route``)
BWD_ROUTES = {"tensor cores": 0, "cuda cores": 0}
#: the largest head size the backward's tensor-core route holds in shared
#: memory and registers
BWD_TENSOR_CORE_MAX_D = 128
#: the input types the split-TF32 kernel takes, and the code its C entry reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head sizes the tensor-core kernel is built for
SM90_HEAD_DIMS = (64, 128)
#: TMA's alignment of every stride but the innermost, and of the base
TMA_ALIGN = 16


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def shard_rule(q, k) -> tuple[list, list, int | None]:
    """Attention's placements on ``q``'s mesh for q (B, Hq, S, D), the
    output and the statistic, and for k and v: ``Shard(0)`` on each mesh
    dim where q is sharded over batch; on a mesh dim where q is sharded over
    heads, ``Shard(1)`` for all of them where its size n divides Hkv, else,
    where n divides Hq and each rank's Hq / n query heads lie in one GQA
    group, q's heads sharded and k, v whole there, each rank reading the
    one KV head of its group (that dim is the third value); every other
    placement ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, Hq, Hkv = q.device_mesh, q.shape[1], k.shape[1]
    qpl, kpl, group_dim = [], [], None
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if pl == Shard(0):
            qpl.append(Shard(0))
            kpl.append(Shard(0))
        elif pl == Shard(1) and Hkv % n == 0:
            qpl.append(Shard(1))
            kpl.append(Shard(1))
        elif pl == Shard(1) and Hq % n == 0 and (Hq // Hkv) % (Hq // n) == 0 \
                and group_dim is None:
            qpl.append(Shard(1))
            kpl.append(Replicate())
            group_dim = i
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    return qpl, kpl, group_dim


def _sharded(fn, tensors, backward=False, **kw):
    """``fn`` on DTensors under ``shard_rule``: q (and the output, the
    statistic and dout) and k, v redistributed to the rule's placements,
    ``fn`` on the local shards (k and v cut to the rank's KV head where the
    rule says so), the outputs wrapped back as DTensors: q's placements for
    the output, the statistic and dq; k's for dk and dv, whose one KV head
    a rank computed is placed into zeros of the whole and summed over the
    ranks that share it (``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial
    q, k = tensors[0], tensors[1]
    mesh = q.device_mesh
    qpl, kpl, gdim = shard_rule(q, k)
    pls = [kpl if i in (1, 2) else qpl for i in range(len(tensors))]
    local = [t.redistribute(mesh, pl).to_local()
             for t, pl in zip(tensors, pls)]
    j = None
    if gdim is not None:
        Hq, Hkv = q.shape[1], k.shape[1]
        j = mesh.get_local_rank(gdim) * (Hq // mesh.size(gdim)) // \
            (Hq // Hkv)
        local[1], local[2] = (t[:, j:j + 1] for t in local[1:3])
    out = fn(*local, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = []
    for i, o in enumerate(outs):
        pl = qpl
        if backward and i > 0:
            pl = list(kpl)
            if j is not None:
                whole = o.new_zeros((o.shape[0], k.shape[1]) + o.shape[2:])
                whole[:, j:j + 1] = o
                o, pl[gdim] = whole, Partial()
        wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False))
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_ROUTES):
        for name in counts:
            counts[name] = 0


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


def bwd_route(D: int) -> str:
    """The backward's route for head size ``D``, in either input type (both
    take the same tiles): ``"tensor cores"`` (split-TF32 wgmma) up to
    ``BWD_TENSOR_CORE_MAX_D``, ``"cuda cores"`` above it. Its C entry
    refuses any other pick."""
    return "tensor cores" if D <= BWD_TENSOR_CORE_MAX_D else "cuda cores"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SPLIT_TF32)
    lib.flash_attention.argtypes = ([P] + [L] * 4) * 4 + [P] + [I] * 11 + \
        [P]
    lib.flash_attention.restype = I
    return lib


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = build.load(SM90)
    lib.flash_attention_sm90.argtypes = [P] * 5 + [L] * 3 + [P] + \
        [I] * 10 + [P]
    lib.flash_attention_sm90.restype = I
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = build.load(BWD)
    lib.flash_attention_bwd.argtypes = ([P] + [L] * 4) * 8 + [P, P] + \
        [I] * 12 + [P]
    lib.flash_attention_bwd.restype = I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, kv_len: int | None = None,
                    return_lse: bool = False
                    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), float32 or bfloat16, any
    strides -> (B, Hq, Sq, D) in q's dtype and strides; with ``return_lse``
    also each row's statistic (B, Hq, Sq), float32, contiguous (the module
    docstring gives its units)."""
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
    if type(q) is not torch.Tensor:
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len, return_lse=return_lse)
        if _is_dtensor(q):
            return _sharded(flash_attention, (q, k, v), **kw)
        if _is_fake(q):
            out = torch.empty_like(q)
            if not return_lse:
                return out
            return out, torch.empty((B, Hq, Sq), dtype=torch.float32,
                                    device=q.device)
    if not q.is_cuda:
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, kv_len=kv_len,
                                        return_lse=return_lse)
    name = route(q, k, v)
    if name == SPLIT_TF32 and (D % 8 or not 8 <= D <= 256):
        raise ValueError(f"the kernel takes a head size D that is a multiple "
                         f"of 8 up to 256; got {D}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if not out.numel():
        return (out, lse) if return_lse else out
    lse_ptr = None if lse is None else lse.data_ptr()
    mask = (int(causal), 0 if window is None else int(window), int(q_offset),
            Skv if kv_len is None else int(kv_len))
    with on_device(q):
        if name == SM90:
            geo = (ctypes.c_ulonglong * 21)(
                *(g for t in (q, k, v) for g in tma_geometry(t)))
            code = _lib_sm90().flash_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geo,
                *out.stride()[:3], lse_ptr, B, Hq, Hkv, Sq, Skv, D, *mask,
                stream(q))
        else:
            code = _lib().flash_attention(
                q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
                v.data_ptr(), *v.stride(), out.data_ptr(), *out.stride(),
                lse_ptr, B, Hq, Hkv, Sq, Skv, D, *mask, DTYPES[q.dtype],
                stream(q))
    raise_on(code, name)
    count_launch(LAUNCHES, name)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        kv_len: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)``,
    whose output was ``out`` and row statistic ``lse`` (``return_lse=True``:
    float32, contiguous (B, Hq, Sq)), against ``dout``: each in its input's
    dtype and strides. Every tensor is read through its strides (the model's
    ``movedim`` views in place). The kernel recomputes P from ``lse``; the
    plain version on the CPU builds its own softmax and does not read it."""
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
    if type(q) is not torch.Tensor:
        if _is_dtensor(q):
            return _sharded(flash_attention_bwd, (q, k, v, out, lse, dout),
                            backward=True, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)
        if _is_fake(q):
            grads = tuple(torch.empty_like(t) for t in (q, k, v))
            torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
            return grads
    if lse.shape != (B, Hq, Sq):
        raise ValueError(f"lse must be (B, Hq, Sq) = {(B, Hq, Sq)}; got "
                         f"{tuple(lse.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32; got {lse.dtype}")
    if lse.device != q.device:
        raise ValueError(f"lse is on {lse.device}, q on {q.device}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous, as the forward returns it")
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
    # rowsum(dO O), which the dq pass leaves for the dk/dv pass
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    mask = (int(causal), 0 if window is None else int(window), int(q_offset),
            Skv if kv_len is None else int(kv_len))
    how = bwd_route(D)
    with on_device(q):
        code = _lib_bwd().flash_attention_bwd(
            *(x for t in (q, k, v, out, dout, dq, dk, dv)
              for x in (t.data_ptr(), *t.stride())),
            lse.data_ptr(), delta.data_ptr(), B, Hq, Hkv, Sq, Skv, D, *mask,
            DTYPES[q.dtype], int(how == "cuda cores"), stream(q))
    raise_on(code, BWD)
    count_launch(LAUNCHES, BWD)
    count_launch(BWD_ROUTES, how)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is the wrapper above
    asked for the row statistic (a kernel on the card, the plain version on
    the CPU), the backward ``flash_attention_bwd`` on the saved q, k, v,
    output and statistic. The forward is looked up in this module when it
    runs, so a caller may stand another attention in for it
    (``chip_smoke.py`` does, to record or compare); it must take
    ``return_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, q_offset=0,
                kv_len=None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None

