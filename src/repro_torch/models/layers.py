"""Shared neural layers of the LM zoo: norms, RoPE, attention, MLPs.

The port of ``repro.models.layers``, with its arithmetic and cast order.
Full-sequence attention (``chunked_attention``) calls the flash kernel's
wrapper (``ops.flash_attention``): on a CUDA tensor it launches a flash
kernel, on a CPU tensor it runs the plain version. Where gradients are
recorded it goes through the kernel's autograd Function
(``ops.FlashAttention``) instead, whose backward launches
``csrc/flash_attention_bwd.cu`` (its plain version on the CPU); serving,
under ``no_grad``, calls the wrapper directly. Single-token decode
attention (``decode_attention``) stays plain PyTorch, as JAX computes it
with jnp outside any Pallas kernel. The projections and MLPs are
``torch.matmul``, as JAX leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa

NEG_INF = -1e30


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast to x's dtype, then multiply by the scale."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ------------------------------------------------------------------ RoPE
def rope_freqs(d_head: int, theta: float,
               device: torch.device | str) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) or (S,) integer. The rotation pairs
    the two halves of the head (not interleaved lanes), as JAX does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    ang = positions[..., None].float() * freqs                   # (.., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0, bq: int = 512, bk: int = 512,
                      kv_len: int | None = None,
                      gqa: str = "grouped") -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    The flash kernels on a CUDA tensor, their plain versions on a CPU
    tensor, differentiable. ``bq``, ``bk`` and ``gqa`` pick JAX's blocking
    and its layout under tensor parallelism; they change no result and are
    accepted for the signature's sake."""
    del bq, bk, gqa
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa.FlashAttention.apply(q, k, v, causal, window, q_offset,
                                       kv_len)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cache_len: int,
                     window: int | None = None,
                     window_rotated: bool = False) -> torch.Tensor:
    """Single-step decode attention against a (B, Hkv, S_max, D) cache.

    ``cache_len`` is the number of valid cache entries. With
    ``window_rotated`` the cache is a ring buffer of size window (SWA
    decode): every slot is valid once full, and positions need no causal
    mask."""
    B, Hq, _, D = q.shape
    S = k_cache.shape[2]
    s = decode_scores(q, k_cache, D)
    kpos = torch.arange(S, device=q.device)
    s = s.masked_fill(~decode_valid(kpos, cache_len, window, window_rotated),
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor,
                  d_head: int) -> torch.Tensor:
    """``decode_attention``'s float32 scores (B, Hkv, Hq / Hkv, S): each
    query head against its GQA group's keys, over ``sqrt(d_head)``."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float() / (d_head ** 0.5)
    return torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())


def decode_valid(kpos: torch.Tensor, cache_len: int, window: int | None,
                 window_rotated: bool) -> torch.Tensor:
    """Which cache positions ``kpos`` a decode step attends to."""
    valid = kpos < cache_len
    if window is not None and not window_rotated:
        valid &= kpos > cache_len - 1 - window
    return valid


# ------------------------------------------------------------------- MLPs
def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out
