"""Jamba-1.5-Large 398B [arXiv:2403.19887]: hybrid Mamba+attention, 72L as
9 periods of [1 attn + 7 mamba] (the 1:7 interleave), MoE 16 experts top-2
every 2nd sublayer (d_ff 24576; dense SwiGLU of the same width otherwise),
d8192, 64H GQA(kv=8), vocab 65536. Param check: 16e*3*8192*24576*36 = 348B
experts + 21.7B dense FFN + 26B mamba + ~2B attn/embed ~= 398B total,
~94B active — matches the published 398B/94B. Optimizer: adafactor
(AdamW state alone would be 3.2 TB). Sub-quadratic via the mamba majority:
long_500k runs; the 9 attn layers keep full 500k KV caches, sharded on the
data axis."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, vocab=65536,
    n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, n_experts=16, top_k=2, d_ff_expert=24576, moe_period=2,
    layer_period=("attn",) + ("mamba",) * 7,
    ssm_d_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    rope_theta=1e6, optimizer="adafactor",
    subquadratic=True,
)
