"""The system under test: the port's ``LM`` at a configuration file's sizes,
with the benchmark's weights drawn into it.

The port's ``ArchConfig`` is built from the file's published keys (and the
sizes it lists as assumed), not from the port's registry, so that the
program runs as the configuration states it.
"""

from __future__ import annotations

import torch

from perfbench import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file."""
    from repro_torch.models.config import ArchConfig
    m = W.dims(cfg)
    moe = bool(m["E"])
    return ArchConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        n_layers=m["L"], d_model=m["d"], vocab=m["V"],
        n_heads=m["hq"], n_kv_heads=m["hkv"], d_head=m["dh"],
        d_ff=0 if moe else m["f"],
        n_experts=m["E"], top_k=m["k"], d_ff_expert=m["f"] if moe else 0,
        capacity_factor=float(cfg.get("capacity_factor", 1.0)),
        attn_window=cfg.get("sliding_window"),
        qk_norm=W.qk_norm(cfg), rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)))


def lm_leaf(lm, name: str) -> torch.Tensor:
    """The port's storage of the benchmark's leaf ``name``."""
    if name.startswith("layers."):
        return lm.stacked[f"blocks/0:attn/{name.split('.', 1)[1]}"]
    return lm.top[name]


def build(cfg: dict, seed: int, device) -> object:
    """The port's ``LM`` on ``device`` in the configuration's type, every
    leaf drawn from ``seed`` into its own storage. Fails if the port holds a
    leaf the benchmark does not draw, or lacks one it does."""
    from repro_torch.models.model import LM
    lm = LM(arch(cfg), dtype=DTYPES[cfg["torch_dtype"]], device=device)
    theirs = {f"layers.{k.split('/')[-1]}" for k in lm.stacked} | set(lm.top)
    ours = {lf.name for lf in W.leaves(cfg)}
    if theirs != ours:
        raise RuntimeError(f"the port's leaves {sorted(theirs ^ ours)} are "
                           f"not the benchmark's")
    with torch.no_grad():
        for lf in W.leaves(cfg):
            W.draw(lf, seed, device=device, dtype=lm.dtype,
                   out=lm_leaf(lm, lf.name))
    return lm
