"""Analytic per-chip FLOPs / HBM-bytes model for the roofline: a copy of
``repro.distributed.analytic`` over the port's ``ArchConfig`` and
``configs/shapes.py``, number for number (a chip is a card here).

Why analytic (JAX's reason; the port counts the same so the two compare):
XLA's cost_analysis does not multiply while-body costs by trip
counts, so any scan-over-layers model is undercounted by ~n_layers. Rather
than unrolling 94-layer stacks (compile-time explosion), we count the costs
the compiled program actually executes from the architecture config — the
standard napkin-math roofline, kept in one auditable place. The dry-run
records BOTH this model and the raw cost_analysis numbers (the latter tagged
with its scan caveat).

FLOPs (global, then /chips):
    matmul params:  2 * (N_active - embed_gather_params) * tokens
    attention:      4 * B * Hq * Dh * sum_ctx   (QK^T + PV, causal/window aware)
    SSD (mamba2):   ~= 2*B*S*H*(Q*N + Q*P + 2*N*P + 3*N*P/chunk-amortized)
    train factor:   fwd * (4 with remat: 1 fwd + 1 remat-fwd + 2 bwd; else 3)
    optimizer:      ~12 flops/param (adam) or ~8 (adafactor)

HBM bytes per chip (first-order traffic, not footprint):
    weights:        N_bytes/chips * passes (fwd, remat, bwd-grad, bwd-wgrad)
    grads+opt:      adam: read+write m,v (f32) + grad + param  ~ 20B/param
    activations:    layer-boundary saves + recompute reads ~ 4 * L * B*S*d*2
    KV/state reads: decode: full cache read per step; prefill: KV stream
    logits path:    B*S*V*2 (+ f32 softmax pass for train)
"""

from __future__ import annotations

from repro_torch.models.config import ArchConfig


def _attn_layers(cfg: ArchConfig) -> int:
    return sum(1 for k in cfg.period for _ in [k] if k == "attn") * cfg.n_periods


def _mamba_layers(cfg: ArchConfig) -> int:
    return sum(1 for k in cfg.period if k == "mamba") * cfg.n_periods


def _tokens(cfg: ArchConfig, cell) -> int:
    if cfg.family == "audio" and cell.kind != "decode":
        return cell.global_batch * cfg.dec_max_len
    if cell.kind == "decode":
        return cell.global_batch
    return cell.global_batch * cell.seq_len


def _attn_flops(cfg: ArchConfig, cell) -> float:
    """4*B*Hq*Dh*sum_over_queries(ctx)."""
    nl = _attn_layers(cfg)
    if nl == 0:
        return 0.0
    B = cell.global_batch
    if cell.kind == "decode":
        ctx = min(cell.seq_len, cfg.attn_window or cell.seq_len)
        per_layer = 4.0 * B * cfg.n_heads * cfg.d_head * ctx
        f = nl * per_layer
    else:
        S = cfg.dec_max_len if cfg.family == "audio" else cell.seq_len
        if cfg.attn_window and cfg.attn_window < S:
            sum_ctx = S * cfg.attn_window  # window-bounded
        else:
            sum_ctx = S * (S + 1) / 2      # causal triangle
        f = nl * 4.0 * B * cfg.n_heads * cfg.d_head * sum_ctx
        if cfg.enc_layers:  # whisper: encoder self (full) + decoder cross
            Senc = cell.seq_len
            f += cfg.enc_layers * 4.0 * B * cfg.n_heads * cfg.d_head * Senc * Senc
            f += cfg.n_layers * 4.0 * B * cfg.n_heads * cfg.d_head * \
                cfg.dec_max_len * cfg.cross_len
    return f


def _ssd_flops(cfg: ArchConfig, cell) -> float:
    nl = _mamba_layers(cfg)
    if nl == 0:
        return 0.0
    B = cell.global_batch
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_state
    if cell.kind == "decode":
        # state update + readout: ~4*H*N*P per token
        return nl * 4.0 * B * H * N * P
    S = cell.seq_len
    Q = cfg.ssm_chunk
    # scores (Q*N) + y_diag (Q*P) + states/y_off (2*N*P) per position
    return nl * 2.0 * B * S * H * (Q * N + Q * P + 2 * N * P)


def estimate(cfg: ArchConfig, cell, chips: int) -> dict:
    toks = _tokens(cfg, cell)
    n_active = cfg.active_param_count()
    # input-embedding gather does no flops — but with tied embeddings the
    # same table still performs the logits matmul, so nothing is subtracted.
    embed_gather = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    n_matmul = max(n_active - embed_gather, 0)
    fwd = 2.0 * n_matmul * toks + _attn_flops(cfg, cell) + _ssd_flops(cfg, cell)

    if cell.kind == "train":
        # fwd(1) + bwd(2) + remat recompute: full policy re-runs the whole
        # forward (+1); dots policy recomputes only non-matmul ops (~+0.15)
        policy = cfg.remat_policy if cfg.remat else "none"
        factor = {"full": 4.0, "dots": 3.15, "none": 3.0}[policy]
        opt = (12.0 if cfg.optimizer == "adamw" else 8.0) * cfg.param_count()
        flops = fwd * factor + opt
    else:
        flops = fwd

    # ---------------- bytes (per-chip HBM traffic) -----------------------
    P_bytes = 2.0 * cfg.param_count()                 # bf16 at rest
    B = cell.global_batch
    S = cfg.dec_max_len if cfg.family == "audio" and cell.kind != "decode" \
        else cell.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    act_unit = B * S * d * 2.0                        # one boundary, bf16
    if cell.kind == "train":
        policy = cfg.remat_policy if cfg.remat else "none"
        wb = P_bytes * {"full": 4.0, "dots": 3.3, "none": 3.0}[policy]
        opt_b = (20.0 if cfg.optimizer == "adamw" else 8.0) * cfg.param_count()
        # dots policy saves ~6 boundary tensors per layer instead of 1
        act_b = {"full": 4.0, "dots": 14.0, "none": 10.0}[policy] * L * act_unit
        logit_b = 2.0 * B * S * cfg.vocab * 2.0 + 4.0 * B * S * cfg.vocab
        byts = wb + opt_b + act_b + logit_b
    elif cell.kind == "prefill":
        byts = P_bytes + 2.0 * L * act_unit + B * S * cfg.vocab * 2.0
    else:  # decode: weight-read + cache-read bound
        n_read = 2.0 * n_active                        # active params, bf16
        kv = 0.0
        nl = _attn_layers(cfg)
        if nl:
            ctx = min(cell.seq_len, cfg.attn_window or cell.seq_len)
            kv += nl * 2.0 * B * cfg.n_kv_heads * ctx * cfg.d_head * 2.0
        nm = _mamba_layers(cfg)
        if nm:
            kv += nm * 2.0 * B * cfg.ssm_heads * cfg.ssm_d_state * \
                cfg.ssm_head_dim * 4.0                 # f32 state r+w
        byts = n_read + kv + B * cfg.vocab * 2.0
    return {
        "flops_per_chip": flops / chips,
        "bytes_per_chip": byts / chips,
        "flops_global": flops,
        "bytes_global": byts,
        "fwd_flops_global": fwd,
        "tokens": toks,
    }
