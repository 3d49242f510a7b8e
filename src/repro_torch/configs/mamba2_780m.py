"""Mamba2-780M [arXiv:2405.21060]: attention-free SSD, 48L, d1536,
d_state 128, head_dim 64 (expand 2 -> d_inner 3072, 48 SSM heads),
vocab 50280, tied embeddings. Sub-quadratic: long_500k runs with O(1)
per-token state."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, vocab=50280,
    ssm_d_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    ssm_chunk=256, tie_embeddings=True,
    subquadratic=True,
)
