"""The benchmark's random weights, drawn on the device from ``--seed``.

Both sides take their weights from here: the program's ``LM`` has each leaf
drawn into its own storage (``perfbench/model.py``), and the reference draws
the same leaves again into fresh tensors after the program is gone. A leaf
is one tensor stacked over the layers, as the port stores it, in ``x @ w``
orientation ((in, out); experts (E, in, out)). Each leaf is one call of
``torch.randn`` on its own generator, seeded from the run's seed and the
leaf's name, in the type it is served in, so a leaf drawn into a tensor and
drawn fresh are the same numbers.

Matrices are normal(0, 0.02) (the published ``initializer_range``); norm
scales 1 + normal(0, 0.1), so that a norm whose scale is skipped or misread
shows; the router is float32, as the port keeps it.

This module imports nothing of the port.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

MATRIX_STD = 0.02
NORM_STD = 0.1


class Leaf(NamedTuple):
    name: str                 # "embed", "layers.wq", ...
    shape: tuple[int, ...]
    kind: str                 # "matrix" | "norm" | "router"


def dims(cfg: dict) -> dict:
    """The sizes the leaves need, from a configuration file's published
    keys."""
    d = cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return {"L": cfg["num_hidden_layers"], "d": d, "V": cfg["vocab_size"],
            "hq": hq, "hkv": hkv,
            "dh": cfg.get("head_dim") or d // hq,
            "f": cfg["intermediate_size"],
            "E": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0)}


def leaves(cfg: dict) -> list[Leaf]:
    """Every leaf of the configuration, in drawing order."""
    m = dims(cfg)
    L, d, dh, f, E = m["L"], m["d"], m["dh"], m["f"], m["E"]
    out = [Leaf("embed", (m["V"], d), "matrix"),
           Leaf("final_norm", (d,), "norm"),
           Leaf("lm_head", (d, m["V"]), "matrix"),
           Leaf("layers.ln", (L, d), "norm"),
           Leaf("layers.wq", (L, d, m["hq"] * dh), "matrix"),
           Leaf("layers.wk", (L, d, m["hkv"] * dh), "matrix"),
           Leaf("layers.wv", (L, d, m["hkv"] * dh), "matrix"),
           Leaf("layers.wo", (L, m["hq"] * dh, d), "matrix"),
           Leaf("layers.ln2", (L, d), "norm")]
    if qk_norm(cfg):
        out += [Leaf("layers.q_norm", (L, dh), "norm"),
                Leaf("layers.k_norm", (L, dh), "norm")]
    if E:
        out += [Leaf("layers.router", (L, d, E), "router"),
                Leaf("layers.w_gate", (L, E, d, f), "matrix"),
                Leaf("layers.w_up", (L, E, d, f), "matrix"),
                Leaf("layers.w_down", (L, E, f, d), "matrix")]
    else:
        out += [Leaf("layers.w_gate", (L, d, f), "matrix"),
                Leaf("layers.w_up", (L, d, f), "matrix"),
                Leaf("layers.w_down", (L, f, d), "matrix")]
    return out


def qk_norm(cfg: dict) -> bool:
    """Qwen3 normalises each head of q and k; the published config says so
    by its model type."""
    return cfg.get("model_type") == "qwen3"


def leaf_seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def draw(leaf: Leaf, seed: int, *, device, dtype: torch.dtype,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """``leaf`` drawn from ``seed``: into ``out`` (contiguous, of the leaf's
    shape) or a fresh tensor. ``dtype`` is the served type; the router is
    float32 whatever it is."""
    dt = torch.float32 if leaf.kind == "router" else dtype
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, leaf.name))
    if out is None:
        out = torch.empty(leaf.shape, dtype=dt, device=device)
    elif out.shape != leaf.shape or out.dtype != dt or not out.is_contiguous():
        raise ValueError(f"{leaf.name}: cannot draw {leaf.shape} {dt} into "
                         f"{tuple(out.shape)} {out.dtype}")
    torch.randn(leaf.shape, generator=g, out=out)
    if leaf.kind == "norm":
        return out.mul_(NORM_STD).add_(1.0)
    return out.mul_(MATRIX_STD)


class Weights:
    """Every leaf drawn afresh on ``device`` (the served type), read as
    float32: ``top(name)`` and ``layer(i)`` (the layer's slice of each
    ``layers.*`` leaf)."""

    def __init__(self, cfg: dict, seed: int, device, dtype: torch.dtype):
        self.leaves = {lf.name: draw(lf, seed, device=device, dtype=dtype)
                       for lf in leaves(cfg)}

    def top(self, name: str) -> torch.Tensor:
        return self.leaves[name].float()

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        return {name.split(".", 1)[1]: t[i].float()
                for name, t in self.leaves.items()
                if name.startswith("layers.")}
