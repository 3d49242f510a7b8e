"""Plain PyTorch version of the flash-attention kernel.

The semantics of ``repro.kernels.flash_attention.ref.flash_attention_ref``
and of ``csrc/flash_attention.cu``: dense masked attention with a float32
softmax. A key at position k is visible to the query at position
``q_offset + i`` when ``k < kv_len``, ``k <= q_offset + i`` (causal) and
``k > q_offset + i - window`` (sliding window). Masked scores are ``-1e30``,
not ``-inf``, so a row that sees no key at all gets a uniform softmax over
all Skv keys: the mean of v over Skv, as the JAX reference gives (its
comment says zero, which it is not). The Pallas kernel's mean over its
zero-padded 128-row block is not copied. GQA groups query heads onto a KV
head as ``h // (Hq // Hkv)`` without repeating K or V in memory.

With ``return_lse=True`` it also returns each row's statistic, the quantity
both forward kernels write for the backward: float32 (B, Hq, Sq), in log2
units scaled as the kernels' exp2 domain is, ``logsumexp(q k^T / sqrt(D))``
over the row's visible keys times log2(e) (equal to ``m + log2(l)`` for
scores scaled by ``scale_log2 = log2(e) / sqrt(D)``), +inf for a row that
sees no key. It is computed densely from the masked scores.

``flash_attention_bwd_ref`` is the plain version of the backward kernel
``csrc/flash_attention_bwd.cu``: the gradients of ``flash_attention_ref``,
written out in float32 rather than taken by autograd, which the forward's
in-place softmax refuses (it overwrites the scores it would need). It
builds its own softmax and takes no statistic, so a wrong statistic from a
forward kernel shows as a difference between the backward kernel and it.

``tf32_round`` and ``split_tf32`` state the rounding rule of the CUDA kernel
``csrc/flash_attention.cu``, which multiplies on the tensor cores in split
TF32; no path calls them, and the tests build a model of that arithmetic
from them.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
#: TF32 keeps 10 of float32's 23 stored mantissa bits
TF32_DROPPED_BITS = 13


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to TF32 the way ``cvt.rna.tf32.f32`` rounds:
    to the nearest value whose low 13 mantissa bits are 0, ties away from
    zero (add half of the dropped range to the bits, then clear them)."""
    bits = x.float().contiguous().view(torch.int32)
    half = 1 << (TF32_DROPPED_BITS - 1)
    mask = ~((1 << TF32_DROPPED_BITS) - 1)
    return ((bits + half) & mask).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` as float32 = hi + lo: hi = tf32(x), lo = tf32(x - hi). The
    kernel takes x * y as hi*hi + hi*lo + lo*hi; lo is 0 for a value that
    TF32 holds exactly, as every bfloat16 value."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0, kv_len: int | None = None,
                        return_lse: bool = False
                        ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype;
    with ``return_lse`` also the rows' statistic (B, Hq, Sq), float32: the
    log-sum-exp of the row's scaled scores over its visible keys in log2
    units (times log2(e)), +inf for a row that sees no key."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kv_len = Skv if kv_len is None else kv_len
    qg = q.reshape(B, Hkv, group, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()).div_(D ** 0.5)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = (kpos[None, :] < kv_len).expand(Sq, Skv)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    # in place: at the prefill shape the (B, Hq, Sq, Skv) scores are the
    # only large buffer, and each step below would otherwise copy them
    s.masked_fill_(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()
    lsum = p.sum(dim=-1, keepdim=True)
    p.div_(torch.where(lsum == 0.0, torch.ones_like(lsum), lsum))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(B, Hq, Sq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = ((m + lsum.log()) * LOG2E).squeeze(-1)
    lse = torch.where(mask.any(dim=-1), lse, torch.inf)
    return out, lse.reshape(B, Hq, Sq).contiguous()


def _visible(Sq: int, Skv: int, causal: bool, window: int | None,
             q_offset: int, kv_len: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: key k is visible to query i (position q_offset + i)."""
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = torch.arange(Skv, device=device)
    mask = (kpos[None, :] < kv_len).expand(Sq, Skv)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            kv_len: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention_ref``'s output
    ``out`` against ``dout`` (both (B, Hq, Sq, D)), each in its input's
    dtype. In float32: P recomputed with the forward's mask and its -1e30
    fill, ``delta = rowsum(dO * O)``, ``dS = P * (dO V^T - delta)`` on the
    visible pairs and 0 elsewhere, ``dQ = scale dS K``, ``dK = scale dS^T Q``
    and ``dV = P^T dO``, dK and dV summed over each GQA group (scale =
    1/sqrt(D)). A row that sees no key has a uniform softmax over all Skv
    keys: its dO/Skv reaches every key's dV, and nothing reaches dQ or dK,
    since the fill is a constant."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kv_len = Skv if kv_len is None else kv_len
    scale = 1.0 / D ** 0.5
    qg = q.reshape(B, Hkv, group, Sq, D).float()
    kf, vf = k.float(), v.float()
    do = dout.reshape(B, Hkv, group, Sq, D).float()
    mask = _visible(Sq, Skv, causal, window, q_offset, kv_len, q.device)
    p = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf).div_(D ** 0.5)
    p.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(p, dim=-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
    delta = (do * out.reshape(B, Hkv, group, Sq, D).float()).sum(
        dim=-1, keepdim=True)
    ds = torch.einsum("bhgqd,bhkd->bhgqk", do, vf).sub_(delta).mul_(p)
    del p
    ds.masked_fill_(~mask, 0.0)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).mul_(scale)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg).mul_(scale)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))

