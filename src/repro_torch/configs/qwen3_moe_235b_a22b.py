"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf]: 94L, d4096,
64H GQA(kv=4), 128 experts top-8 (expert d_ff 1536), vocab 151936, qk_norm.
Optimizer: adafactor (AdamW m/v at 235B exceeds the single-pod HBM budget —
the co-design planner's verdict; see EXPERIMENTS.md §Dry-run)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, vocab=151936,
    n_heads=64, n_kv_heads=4, d_head=128,
    n_experts=128, top_k=8, d_ff_expert=1536,
    qk_norm=True, rope_theta=1e6,
    optimizer="adafactor",
)
