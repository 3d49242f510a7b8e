"""Abstract input specs of every (arch x shape) cell: the port of
``repro.launch.specs``. They are meta tensors (torch's
``ShapeDtypeStruct``): shapes and dtypes, no storage. The dry-run
(``launch.dryrun``) lays them out over a mesh; ``tree_bytes`` counts them.

Frontend stubs as in JAX: [audio] gets precomputed frame embeddings
(B, S, d) in bf16 beside ``dec_max_len`` decoder tokens, [vlm]
precomputed patch embeddings (B, n_patches, d). A decode cell's cache is
``init_cache`` of a meta ``LM`` in bf16 (the attention caches in the
model's dtype, the SSM state in float32, as JAX's), with JAX's ``enc_len``
(``cross_len`` for an encoder-decoder), and its ``len`` the int32 scalar
JAX passes.
"""

from __future__ import annotations

import torch

from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LM

I32 = torch.int32
BF16 = torch.bfloat16


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape_name: str, cell=None) -> dict:
    """``cell`` (a ``ShapeCell``) replaces ``SHAPES[shape_name]``: an
    off-grid batch and length."""
    cell = cell or SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "audio":
        return {"tokens": sds((B, cfg.dec_max_len), I32),
                "labels": sds((B, cfg.dec_max_len), I32),
                "enc_frames": sds((B, S, cfg.d_model), BF16)}
    out = {"tokens": sds((B, S), I32), "labels": sds((B, S), I32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = sds((B, cfg.n_patches, cfg.d_model), BF16)
    return out


def prefill_specs(cfg: ArchConfig, shape_name: str, cell=None) -> dict:
    b = train_batch_specs(cfg, shape_name, cell)
    b.pop("labels")
    return b


def decode_specs(cfg: ArchConfig, shape_name: str, lm: LM | None = None,
                 cell=None) -> dict:
    """(cache, tokens) for serve_step: one new token against a KV/SSM cache
    of seq_len. ``lm`` is a meta ``LM`` of ``cfg`` in bf16 (built here when
    not given)."""
    cell = cell or SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    lm = lm if lm is not None else LM(cfg, dtype=BF16, device="meta")
    enc_len = cfg.cross_len if cfg.enc_layers else None
    cache = lm.init_cache(B, S, enc_len=enc_len)
    cache["len"] = sds((), I32)
    return {"cache": cache, "tokens": sds((B, 1), I32)}

