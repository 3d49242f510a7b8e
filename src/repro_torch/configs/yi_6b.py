"""Yi-6B [arXiv:2403.04652; hf]: llama-arch, 32L, d4096, 32H GQA(kv=4),
d_ff 11008, vocab 64000."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, vocab=64000,
    n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, rope_theta=5e6,
)
