"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407; hf]: 40L, d5120,
32H GQA(kv=8) head_dim 128, d_ff 14336, vocab 131072, 128k ctx (full
attention — long_500k skipped per assignment rule)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, vocab=131072,
    n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, rope_theta=1e6,
)
