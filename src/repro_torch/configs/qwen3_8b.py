"""Qwen3-8B [hf:Qwen/Qwen3-8B; hf]: 36L, d4096, 32H GQA(kv=8), d_ff 12288,
vocab 151936, qk_norm."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, vocab=151936,
    n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12288, qk_norm=True, rope_theta=1e6,
)
