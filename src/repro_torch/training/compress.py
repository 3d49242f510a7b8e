"""Gradient compression: symmetric int8 quantisation with error feedback —
the port of ``repro.training.compress``.

Each leaf's gradient plus its carried residual ``x`` is scaled by
``amax(|x|) / 127`` over the whole leaf (1 where x is all zero), rounded
half to even (``torch.round``, as ``jnp.round``), clipped to [-127, 127] and
sent as int8; the residual keeps ``x - q * scale`` for the next step. On the
same arrays ``q``, ``scale`` and the residual are JAX's bit for bit. A leaf
is JAX's: for the LM a whole stacked leaf (``models.convert.leaf_groups``),
so the scale is one per stacked leaf, as in JAX. Trees are dicts of tensors
keyed like the parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compressed(NamedTuple):
    q: dict       # int8 leaves
    scale: dict   # float32 scalar per leaf


def init_residual(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def compress_leaf(g: torch.Tensor, r: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad + residual) of one leaf -> (q int8, scale, new residual)."""
    x = g.to(torch.float32) + r
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - decompress_leaf(q, scale)


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress(grads: dict, residual: dict) -> tuple[Compressed, dict]:
    """(grads + residual) -> int8; new residual = input - dequantised."""
    q, scale, new_r = {}, {}, {}
    for k, g in grads.items():
        q[k], scale[k], new_r[k] = compress_leaf(g, residual[k])
    return Compressed(q, scale), new_r


def decompress(c: Compressed) -> dict:
    return {k: decompress_leaf(q, c.scale[k]) for k, q in c.q.items()}


def wire_bytes(c: Compressed) -> int:
    """Bytes that would cross the network (int8 payload + scales)."""
    return sum(q.numel() for q in c.q.values()) + 4 * len(c.scale)
