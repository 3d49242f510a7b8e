"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L, d4096, 32H GQA(kv=8), 8 experts
top-2 (expert d_ff 14336), vocab 32000, sliding-window attention (4096) —
SWA makes it sub-quadratic, so long_500k runs with a window-sized KV ring."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, vocab=32000,
    n_heads=32, n_kv_heads=8, d_head=128,
    n_experts=8, top_k=2, d_ff_expert=14336,
    attn_window=4096, rope_theta=1e6,
    subquadratic=True,
)
