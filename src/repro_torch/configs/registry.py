"""Architecture registry of the port: the ten LM configurations of
``repro.configs``, selectable via ``--arch <id>``, each a copy of its JAX
file with the same published numbers.

Every entry lives in its own ``configs/<id>.py`` with the exact published
numbers; ``reduced()`` shrinks any config to a CPU-smoke size while
preserving the family structure (period layout, GQA ratio, MoE top-k, SSD)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "mixtral_8x7b",
    "qwen3_moe_235b_a22b",
    "mistral_nemo_12b",
    "qwen2_5_32b",
    "yi_6b",
    "qwen3_8b",
    "whisper_tiny",
    "mamba2_780m",
    "jamba_1_5_large",
    "internvl2_26b",
]

# public cell ids from the assignment -> module names
ALIASES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2.5-32b": "qwen2_5_32b",
    "yi-6b": "yi_6b",
    "qwen3-8b": "qwen3_8b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "internvl2-26b": "internvl2_26b",
}


def get_config(arch: str) -> ArchConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving reduction for CPU smoke tests."""
    kv_ratio = max(1, (cfg.n_heads or 4) // max(cfg.n_kv_heads or 1, 1))
    n_heads = 4
    n_kv = max(1, n_heads // min(kv_ratio, n_heads))
    period = cfg.period
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=len(period) * (2 if len(period) == 1 else 1),
        d_model=64,
        n_heads=n_heads if cfg.n_heads else 0,
        n_kv_heads=n_kv if cfg.n_heads else 0,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(4, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        capacity_factor=8.0,   # drop-free at smoke scale (full cfgs keep 1.0)
        ssm_d_state=16 if cfg.ssm_d_state else 0,
        ssm_head_dim=8,
        ssm_chunk=16,
        attn_window=16 if cfg.attn_window else None,
        enc_layers=2 if cfg.enc_layers else 0,
        cross_len=24 if cfg.enc_layers else cfg.cross_len,
        dec_max_len=32,
        n_patches=8,
        remat=False,
    )
