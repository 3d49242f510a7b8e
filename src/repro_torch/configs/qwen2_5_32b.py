"""Qwen2.5-32B [hf:Qwen/Qwen2.5 family; hf]: 64L, d5120, 40H GQA(kv=8),
d_ff 27648, vocab 152064, QKV bias. 40 heads do NOT divide the 16-way model
axis — the sharding resolver falls back to head-dim sharding (DESIGN.md §5)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, vocab=152064,
    n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=27648, qkv_bias=True, rope_theta=1e6,
)
