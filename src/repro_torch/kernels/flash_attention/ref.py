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
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        kv_len: int | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype."""
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
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    lsum = p.sum(dim=-1, keepdim=True)
    p.div_(torch.where(lsum == 0.0, torch.ones_like(lsum), lsum))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)
