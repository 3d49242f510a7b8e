"""A plain float32 decoder-only transformer, written from the published
architectures of Qwen3 and Mixtral, that the benchmark holds the port to.

One layer: x + attention(rmsnorm(x)), then + FFN(rmsnorm(.)). Attention is
grouped-query (each KV head serves Hq / Hkv query heads), with Qwen3's RMS
norm of each head of q and k before RoPE; RoPE rotates the two halves of
each head (``rotate_half``, as the published models do) by angles worked
out in float64; scores over sqrt(d_head), causal, a sliding window where the
configuration states one. The FFN is SwiGLU, or a top-k mixture of SwiGLU
experts: a float32 softmax router, the k largest (the lowest expert first
among equal probabilities), renormalised. Where ``capacity`` is on, each
batch row gives each expert at most C = max(8, 8 * ceil(ceil(S * k / E *
factor) / 8)) of its S * k assignments, in order of position then choice,
and drops the rest (the port's rule, which the configuration lists as
assumed); off, nothing drops (one token at a time, as a decode step sees
it). Then a final RMS norm and an untied head. The expert layers can
follow a routing handed to them (the program's, whose choices flip at
near-ties under rounding) and judge it against their own.

Every product runs through ``mm(a, w)``: float32 without TF32 here
(``fp32``), or the control's precision (``fp8``). Attention's own products
and the router stay float32 in both. The weights come from ``weights``
(``perfbench/weights.py``: ``top(name)``, ``layer(i)``); the tokens from the
benchmark. This module imports nothing of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0      # largest finite float8_e4m3fn


def fp32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), read back as float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product with both operands in float8 e4m3, scaled per row of a
    and per column of w (the usual fp8 serving recipe), accumulated in
    float32."""
    return _q8(a, -1) @ _q8(w, -2)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions pos (S,)."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = pos.to(torch.float64)[:, None] * inv                  # (S, D/2)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int | None, block: int) -> torch.Tensor:
    """q (B, S, Hq, D), k and v (B, S, Hkv, D) -> (B, S, Hq, D): causal,
    each query sees the last ``window`` keys where a window is set; in
    blocks of ``block`` queries."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qh = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, S, D) / math.sqrt(D)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)      # (B, Hkv, S, D)
    out = torch.empty(B, Hkv, G, S, D, dtype=q.dtype, device=q.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        lo = 0 if window is None else max(0, s0 - window + 1)
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qh[:, :, :, s0:s1],
                          kh[:, :, lo:s1])
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        ki = torch.arange(lo, s1, device=q.device)[None, :]
        seen = ki <= qi
        if window is not None:
            seen &= ki > qi - window
        sc = sc.masked_fill(~seen, float("-inf")).softmax(dim=-1)
        out[:, :, :, s0:s1] = torch.einsum("bhgqk,bhkd->bhgqd", sc,
                                           vh[:, :, lo:s1])
    return out.reshape(B, Hq, S, D).permute(0, 2, 1, 3)


def expert_capacity(S: int, k: int, E: int, factor: float) -> int:
    c = math.ceil(S * k / E * factor)
    return max(8, 8 * math.ceil(c / 8))


def capacity_keep(e: torch.Tensor, E: int, factor: float) -> torch.Tensor:
    """Which assignments e (B, S, k) their experts take under the capacity
    rule: each batch row gives each expert its first C assignments, in
    order of position then choice."""
    B, S, k = e.shape
    C = expert_capacity(S, k, E, factor)
    onehot = F.one_hot(e.reshape(B, S * k), E)                  # (B, S*k, E)
    rank = (onehot.cumsum(dim=1) * onehot).sum(-1) - 1          # (B, S*k)
    return (rank < C).reshape(B, S, k)


def route(h: torch.Tensor, router: torch.Tensor, k: int,
          factor: float | None):
    """-> (probabilities (B, S, E), experts (B, S, k), kept (B, S, k)): the
    float32 softmax, its k largest, and which assignments their experts
    take (all of them where ``factor`` is None)."""
    probs = torch.softmax(h @ router, dim=-1)
    e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        ..., :k]
    kept = torch.ones_like(e, dtype=torch.bool) if factor is None \
        else capacity_keep(e, router.shape[1], factor)
    return probs, e, kept


def judge_routing(probs, e, kept, factor, judge: dict) -> None:
    """How far the routing (e, kept) that was followed departs from the
    reference's own on probs: how many chosen experts are not among the
    reference's k most probable (``route_flips`` of ``route_choices``), and
    how many assignments are kept or dropped against the capacity rule
    applied to those choices (``drop_mismatch``)."""
    k = e.shape[-1]
    own = torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        ..., :k]
    flips = int((~(e[..., :, None] == own[..., None, :]).any(-1)).sum())
    judge["route_flips"] = judge.get("route_flips", 0) + flips
    judge["route_choices"] = judge.get("route_choices", 0) + e.numel()
    rule = torch.ones_like(kept) if factor is None \
        else capacity_keep(e, probs.shape[-1], factor)
    judge["drop_mismatch"] = judge.get("drop_mismatch", 0) + int(
        (rule != kept).sum())


def moe(h, p, k: int, factor: float | None, mm, given=None, judge=None,
        record=None) -> torch.Tensor:
    """The expert layer on h (B, S, d). ``given``: the routing (experts,
    kept) to follow instead of the reference's own, judged into ``judge``;
    ``record`` collects the routing used."""
    probs, e, kept = route(h, p["router"], k, factor)
    if given is not None:
        e, kept = given
        if judge is not None:
            judge_routing(probs, e, kept, factor, judge)
    if record is not None:
        record.append((e, kept))
    w = probs.gather(-1, e)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for x in range(p["w_gate"].shape[0]):
        b, s, j = torch.nonzero((e == x) & kept, as_tuple=True)
        if b.numel() == 0:
            continue
        hx = h[b, s]
        y = mm(F.silu(mm(hx, p["w_gate"][x])) * mm(hx, p["w_up"][x]),
               p["w_down"][x])
        out.index_put_((b, s), y * w[b, s, j, None], accumulate=True)
    return out


def hidden(cfg: dict, weights, tokens: torch.Tensor, *, capacity: bool = True,
           mm=fp32, block: int = 1024, routing=None, judge=None,
           record=None) -> torch.Tensor:
    """tokens (B, S) -> the final norm's output (B, S, d), float32, every
    row at positions 0 .. S-1. ``capacity`` applies the configuration's
    capacity factor to the experts (False: a decode step's view). ``routing``,
    one (experts, kept) per expert layer, is followed instead of the
    reference's own and judged into ``judge``; ``record`` collects each
    expert layer's routing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or cfg["hidden_size"] // hq
    window = cfg.get("sliding_window")
    k = cfg.get("num_experts_per_tok", 0)
    factor = cfg.get("capacity_factor", 1.0) if capacity else None
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = weights.top("embed")[tokens.long()]
    moe_layer = 0
    for i in range(cfg["num_hidden_layers"]):
        p = weights.layer(i)
        h = rmsnorm(x, p["ln"], eps)
        q = mm(h, p["wq"]).view(B, S, hq, D)
        kk = mm(h, p["wk"]).view(B, S, hkv, D)
        v = mm(h, p["wv"]).view(B, S, hkv, D)
        if "q_norm" in p:
            q, kk = rmsnorm(q, p["q_norm"], eps), rmsnorm(kk, p["k_norm"], eps)
        q, kk = rope(q, pos, theta), rope(kk, pos, theta)
        a = attention(q, kk, v, window, block).reshape(B, S, hq * D)
        x = x + mm(a, p["wo"])
        h = rmsnorm(x, p["ln2"], eps)
        if "router" in p:
            given = routing[moe_layer] if routing is not None else None
            x = x + moe(h, p, k, factor, mm, given, judge, record)
            moe_layer += 1
        else:
            x = x + mm(F.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"]),
                       p["w_down"])
        del p, h, q, kk, v, a
    return rmsnorm(x, weights.top("final_norm"), eps)


def logits(head: torch.Tensor, h: torch.Tensor, mm=fp32) -> torch.Tensor:
    """The head (d, V), float32, on final hidden states h (..., d) ->
    (..., V) float32."""
    return mm(h, head)
