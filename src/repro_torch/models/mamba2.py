"""Mamba-2 (SSD, state-space duality) mixer, chunked, plus O(1) decode.

The port of ``repro.models.mamba2`` (``SSMState``, ``ssd_chunked``,
``mamba2_mixer``, ``mamba2_decode_step``, ``ssd_naive_ref``), with its
arithmetic and cast order. The sequence is split into chunks of length Q;
within a chunk the output is a masked quadratic form, across chunks a linear
recurrence carries the (H, N, P) state in float32.

JAX writes two of the products as three-operand einsums
(``"bcqth,bcqth,bcthp->bcqhp"``, ``"bcthn,bcth,bcthp->bchnp"``). Here each is
an elementwise product, then one batched matrix product: a three-operand
``torch.einsum`` may take a contraction path that materialises a
(B, nc, Q, Q, H, P) tensor, 25.8 GB in float32 at Mamba2-780M's prefill.
The products are ``torch.matmul``, as JAX leaves its einsums to XLA; no
kernel of this package runs here.

Shapes: x (B, S, H, P) head inputs, a (B, S, H) log-decay (A * dt,
negative), B_/C_ (B, S, G, N) input/output projections (G groups broadcast
over H).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

Constrain = Callable[[torch.Tensor, tuple], torch.Tensor]


class SSMState(NamedTuple):
    state: torch.Tensor     # (B, H, N, P) float32
    conv: torch.Tensor      # (B, K-1, conv_ch) rolling conv window


def _expand_groups(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N) by repeating each group H/G times."""
    G = t.shape[2]
    if G == H:
        return t
    return t.repeat_interleave(H // G, dim=2)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int,
                constrain: Constrain | None = None,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, S, H, P) float32, final state (B, H, N, P) float32). x is
    already scaled by dt. ``constrain`` is JAX's callback, handed the
    chunked x, B and C in JAX's (B, nc, Q, H, .) layout, heads on "model",
    before they are permuted to the port's (B, nc, H, Q, .). Those calls
    keep JAX's sequence of constraints and never act: the dry-run runs this
    function inside its ``ssd_chunked`` region on each rank's plain shards,
    whose placements (the same heads on "model") stand in for them."""
    constrain = constrain or (lambda t, axes: t)
    B, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    # self-pad S to a chunk multiple: a = 0, x = 0 padding is a no-op on the
    # state (decay exp(0) = 1, zero input); the padded outputs are cut off
    s_pad = (-S) % Q
    if s_pad:
        x = F.pad(x, (0, 0, 0, 0, 0, s_pad))
        a = F.pad(a, (0, 0, 0, s_pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, s_pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, s_pad))
    S_p = S + s_pad
    nc = S_p // Q

    # chunk views, heads moved ahead of the positions: (B, nc, H, Q, .)
    heads = ("data", None, None, "model", None)
    xc = constrain(x.float().reshape(B, nc, Q, H, P), heads).permute(
        0, 1, 3, 2, 4)
    Bc = constrain(_expand_groups(B_, H).float().reshape(B, nc, Q, H, N),
                   heads).permute(0, 1, 3, 2, 4)
    Cc = constrain(_expand_groups(C_, H).float().reshape(B, nc, Q, H, N),
                   heads).permute(0, 1, 3, 2, 4)
    cum = torch.cumsum(a.float().reshape(B, nc, Q, H), dim=2).permute(
        0, 1, 3, 2)                                              # (B,nc,H,Q)

    # ---- intra-chunk (diagonal) term: masked quadratic form
    # L[q, t] = exp(cum[q] - cum[t]) for q >= t; the mask goes on BEFORE exp
    # (future positions have seg > 0 and would overflow)
    seg = cum[..., :, None] - cum[..., None, :]                  # (B,nc,H,Q,Q)
    qi = torch.arange(Q, device=x.device)
    causal = qi[:, None] >= qi[None, :]
    L = torch.exp(seg.masked_fill_(~causal, -1e30))
    scores = Cc @ Bc.transpose(-1, -2)                           # (B,nc,H,Q,Q)
    y_diag = (scores * L) @ xc                                   # (B,nc,H,Q,P)

    # ---- chunk states
    decay_to_end = torch.exp(cum[..., -1:] - cum)                # (B,nc,H,Q)
    states = (Bc * decay_to_end[..., None]).transpose(-1, -2) @ xc  # (.,N,P)

    # ---- inter-chunk recurrence
    chunk_decay = torch.exp(cum[..., -1])                        # (B,nc,H)
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B,nc,H,N,P)

    # ---- inter-chunk output term
    state_decay = torch.exp(cum)                                 # (B,nc,H,Q)
    y_off = (Cc * state_decay[..., None]) @ prev_states          # (B,nc,H,Q,P)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(B, S_p, H, P)
    return y[:, :S], s


def mamba2_mixer(x: torch.Tensor, p, cfg, constrain: Constrain | None = None,
                 state: SSMState | None = None, return_state: bool = False):
    """The Mamba-2 block on x (B, S, d_model). p holds in_proj, conv_w
    (K, ch), conv_b, A_log (H,), D (H,), dt_bias (H,), norm (d_inner,) and
    out_proj."""
    B, S, _ = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_state, \
        cfg.ssm_n_groups
    d_in = cfg.d_inner
    K = cfg.ssm_conv
    conv_ch = d_in + 2 * G * N

    zxbcdt = x @ p["in_proj"]                    # (B, S, 2*d_in + 2GN + H)
    z, xBC, dt = _split_columns(zxbcdt, [d_in, conv_ch, H])

    # causal depthwise conv over xBC (window K), then SiLU; the sum starts
    # from the first term, in x's dtype, as JAX's Python sum does
    if state is None:
        pad = torch.zeros((B, K - 1, conv_ch), dtype=xBC.dtype,
                          device=x.device)
    else:
        pad = state.conv.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)            # (B, S+K-1, ch)
    conv = xp[:, 0:S] * p["conv_w"][0]
    for j in range(1, K):
        conv = conv + xp[:, j:j + S] * p["conv_w"][j]
    xBC = F.silu(conv + p["conv_b"])
    new_conv = xp[:, S:, :]                      # the last K-1 raw inputs

    x_in, B_, C_ = _split_columns(xBC, [d_in, G * N, G * N])
    x_in = x_in.reshape(B, S, H, P)
    B_ = B_.reshape(B, S, G, N)
    C_ = C_.reshape(B, S, G, N)

    dt = _softplus(dt.float() + p["dt_bias"])                    # (B, S, H)
    A = -torch.exp(p["A_log"].float())                           # (H,)
    a = A * dt                                                   # log decay
    x_dt = x_in.float() * dt[..., None]

    y, fstate = ssd_chunked(x_dt, a, B_, C_, cfg.ssm_chunk, constrain,
                            init_state=None if state is None else state.state)
    y = _skip(y, p["D"], x_in)
    y = y.reshape(B, S, d_in).to(x.dtype)
    out = _gated_norm_out(y, z, p, cfg.norm_eps)
    if return_state:
        return out, SSMState(state=fstate, conv=new_conv)
    return out


def _split_columns(t: torch.Tensor, sizes: list) -> tuple:
    """``t``'s last dim split into parts of ``sizes`` columns."""
    return torch.split(t, sizes, dim=-1)


def _skip(y: torch.Tensor, D: torch.Tensor, x_in: torch.Tensor):
    """The SSD's output y (B, S, H, P) plus the skip ``D * x_in``."""
    return y + D[:, None] * x_in.float()


def _mean_last(t: torch.Tensor) -> torch.Tensor:
    """``t``'s mean over its last dim, kept."""
    return torch.mean(t, dim=-1, keepdim=True)


def _gated_norm_out(y, z, p, eps):
    """Mamba-2's gated RMSNorm, then the output projection."""
    g = y * F.silu(z)
    g32 = g.float()
    var = _mean_last(g32 * g32)
    g = (g32 * torch.rsqrt(var + eps)).to(y.dtype)
    return (g * p["norm"]) @ p["out_proj"]


def mamba2_decode_step(x_t: torch.Tensor, p, cfg,
                       state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """One token: x_t (B, 1, d) -> (y (B, 1, d), the new state). O(1) in the
    context length."""
    B = x_t.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_state, \
        cfg.ssm_n_groups
    d_in = cfg.d_inner
    conv_ch = d_in + 2 * G * N

    zxbcdt = x_t[:, 0] @ p["in_proj"]            # (B, ...)
    z, xBC, dt = torch.split(zxbcdt, [d_in, conv_ch, H], dim=-1)

    win = torch.cat([state.conv.to(xBC.dtype), xBC[:, None, :]], dim=1)
    conv = torch.einsum("bkc,kc->bc", win, p["conv_w"])
    xBC = F.silu(conv + p["conv_b"])
    new_conv = win[:, 1:, :]

    x_in, B_, C_ = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    x_in = x_in.reshape(B, H, P)
    B_ = _expand_groups(B_.reshape(B, 1, G, N), H)[:, 0]         # (B, H, N)
    C_ = _expand_groups(C_.reshape(B, 1, G, N), H)[:, 0]

    dt = _softplus(dt.float() + p["dt_bias"])                    # (B, H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(A * dt)                                    # (B, H)
    x_dt = x_in.float() * dt[..., None]                          # (B, H, P)

    s = state.state * decay[:, :, None, None] \
        + B_.float()[..., :, None] * x_dt[..., None, :]          # (B,H,N,P)
    y = (C_.float()[..., None, :] @ s)[..., 0, :]                # (B, H, P)
    y = y + p["D"][:, None] * x_in.float()
    y = y.reshape(B, d_in).to(x_t.dtype)
    out = _gated_norm_out(y, z, p, cfg.norm_eps)[:, None, :]
    return out, SSMState(state=s, conv=new_conv)


def ssd_naive_ref(x: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                  C_: torch.Tensor) -> torch.Tensor:
    """The sequential-recurrence oracle: the SSM stepped one token at a
    time. x (B, S, H, P) pre-scaled by dt, a (B, S, H) log decay."""
    B, S, H, P = x.shape
    N = B_.shape[-1]
    Bh = _expand_groups(B_, H).float()
    Ch = _expand_groups(C_, H).float()
    s = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dec = torch.exp(a[:, t].float())                         # (B, H)
        s = s * dec[:, :, None, None] \
            + Bh[:, t, :, :, None] * x[:, t].float()[:, :, None, :]
        ys.append((Ch[:, t, :, None, :] @ s)[..., 0, :])
    return torch.stack(ys, dim=1)                                # (B,S,H,P)
