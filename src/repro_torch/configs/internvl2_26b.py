"""InternVL2-26B [arXiv:2404.16821; hf]: InternViT frontend (STUB — patch
embeddings provided precomputed at d_model by input_specs) + InternLM2-20B
backbone: 48L, d6144, 48H GQA(kv=8), d_ff 16384, vocab 92553. The 92553
vocab does not divide the 16-way model axis; the resolver replicates the
embedding and shards the contraction instead (DESIGN.md §5)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, vocab=92553,
    n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, rope_theta=1e6,
    frontend="vision", n_patches=256,
)
