"""Architecture configuration of the LM zoo — the port's own copy of
``repro.models.config``, field for field, so that a configuration means the
same in both packages (the CPU tests compare them with ``dataclasses.asdict``).

Families: dense / moe / ssm / hybrid / audio (enc-dec) / vlm. Heterogeneous
stacks (Jamba) are a repeating *period* of sublayers, ``n_layers /
len(period)`` times. The port runs every family (``models/model.py``).
``fsdp_weight_gather`` and ``activation_constraints`` steer the sharding
constraints the model hands its ``constrain`` callback, as in JAX: they
take effect on a sharded program (``DTensor``s, the dry-run) and change
nothing on one card. ``attn_gqa_mode`` (JAX's GQA layout under XLA) has no
counterpart: the port has one attention.
``remat`` and ``remat_policy`` place the port's checkpoints where JAX
places its own; ``moe_buf_mode="shard_map"`` runs the MoE sublayers expert
parallel (``moe.moe_ffn_shard_map``) where the model's mesh has a "model"
dim that divides E. Its other values have no effect: ``moe_ffn`` hands
its ``constrain`` JAX's buffer axes for them, but no constraint inside
``moe_ffn`` acts, on one card or in the dry-run, whose ``moe_ffn`` region
places the rows and experts itself (``launch/dryrun.py::no_effect`` says
so in each record).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 128
    d_ff: int = 0                    # dense FFN hidden size
    # attention flavor
    attn_window: int | None = None   # sliding-window attention (Mixtral)
    qk_norm: bool = False            # Qwen3
    qkv_bias: bool = False           # Qwen2.5
    attn_gqa_mode: str = "grouped"   # grouped | repeat (§Perf knob, layers.py)
    rope_theta: float = 1e6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1              # MoE every k-th layer (Jamba: 2)
    capacity_factor: float = 1.0
    moe_buf_mode: str = "e_sharded"  # e_sharded | local (§Perf knob, moe.py)
    # SSM (Mamba2 / SSD)
    ssm_d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1
    # hybrid layout: sublayer kinds within one period, e.g. Jamba
    layer_period: tuple[str, ...] = ()   # ("attn","mamba",... ) len divides n_layers
    # encoder-decoder (Whisper)
    enc_layers: int = 0
    dec_max_len: int = 448
    cross_len: int = 1500
    # frontend stub ([audio]/[vlm]: precomputed embeddings via input_specs)
    frontend: str | None = None      # None|"audio"|"vision"
    n_patches: int = 256             # vlm prefix patches
    # numerics / misc
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    act: str = "silu"                # silu (gated) | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    optimizer: str = "adamw"         # adamw|adafactor (co-design: fits-in-HBM)
    remat: bool = True
    remat_policy: str = "full"       # full | dots | none (§Perf iteration knob)
    # ZeRO-3 weight-gather: params stay data-sharded at rest, but each scan
    # step constrains the current layer's weights to TP-only — XLA inserts a
    # per-layer weight all-gather instead of resharding ACTIVATIONS (the
    # measured dominant collective in FSDP baselines). §Perf iteration knob.
    fsdp_weight_gather: bool = False
    # emit with_sharding_constraint on mid-layer activations (q/k heads, FFN
    # hidden, MoE buffers). §Perf finding: forcing these can FIGHT GSPMD's
    # propagation and insert (B,S,d)-sized reshards per layer; False lets
    # propagation run free except at step boundaries (tokens/logits).
    activation_constraints: bool = True
    # long-context applicability (assignment: long_500k needs sub-quadratic)
    subquadratic: bool = False

    # ------------------------------------------------------------ derived
    @property
    def period(self) -> tuple[str, ...]:
        if self.layer_period:
            return self.layer_period
        if self.family == "ssm":
            return ("mamba",)
        return ("attn",)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, \
            f"{self.name}: n_layers {self.n_layers} % period {len(self.period)}"
        return self.n_layers // len(self.period)

    def is_moe_layer(self, idx_in_period: int) -> bool:
        """Whether sublayer `idx_in_period` carries a MoE FFN."""
        if self.n_experts == 0:
            return False
        return idx_in_period % self.moe_period == 0

    @property
    def d_inner(self) -> int:        # mamba
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6*N*D)."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.period * self.n_periods):
            if kind == "attn":
                q = d * self.n_heads * self.d_head
                kv = 2 * d * self.n_kv_heads * self.d_head
                o = self.n_heads * self.d_head * d
                total += q + kv + o
            elif kind == "mamba":
                d_in = self.d_inner
                conv_ch = d_in + 2 * self.ssm_n_groups * self.ssm_d_state
                total += d * (2 * d_in + 2 * self.ssm_n_groups * self.ssm_d_state
                              + self.ssm_heads)      # in_proj
                total += conv_ch * self.ssm_conv     # conv
                total += d_in * d                    # out_proj
            if kind in ("attn", "mamba"):
                if self.is_moe_layer(i % len(self.period)) and self.n_experts:
                    total += self.n_experts * 3 * d * self.d_ff_expert
                elif self.d_ff:
                    mult = 3 if self.act == "silu" else 2
                    total += mult * d * self.d_ff
        if self.enc_layers:  # whisper encoder + cross-attn in decoder
            enc = self.enc_layers * (4 * d * self.n_heads * self.d_head
                                     + 2 * d * self.d_ff)
            cross = self.n_layers * 4 * d * self.n_heads * self.d_head
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        dense = self.param_count()
        n_moe = sum(1 for i in range(len(self.period))
                    if self.is_moe_layer(i)) * self.n_periods
        all_experts = n_moe * self.n_experts * 3 * self.d_model * self.d_ff_expert
        active = n_moe * self.top_k * 3 * self.d_model * self.d_ff_expert
        return dense - all_experts + active
