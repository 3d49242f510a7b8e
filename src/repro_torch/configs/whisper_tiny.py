"""Whisper-tiny [arXiv:2212.04356]: enc-dec, 4+4L, d384, 6H MHA, d_ff 1536,
vocab 51865, LayerNorm+GELU, no RoPE (sinusoidal enc / learned-ish dec).
Conv frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, seq, 384) per the assignment. d_head = 384/6 = 64."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, vocab=51865,
    n_heads=6, n_kv_heads=6, d_head=64,
    d_ff=1536, enc_layers=4, cross_len=1500, dec_max_len=448,
    norm="layernorm", act="gelu", rope_theta=0.0,
    frontend="audio",
)
