"""Time-to-first-spike (TTFS) encoding and grouped decoding, on tensors.

The port of ``repro.core.ttfs``; the semantics are integer and identical:

Encoding (input layer): pixel intensity x in [0,1] maps to spike time
    t = floor((1 - x) * (T - 1))            if x >= x_min   (brighter => earlier)
    t = T  (sentinel: never spikes)          otherwise
computed in float32, as the JAX package does: a float64 encode moves floors
at bin boundaries.

Decoding (output layer, paper §2.3): the label is the group holding the
earliest first output spike, ties to the lowest group id; if nothing spiked,
the "membrane" fallback takes the group with the largest final membrane
(ties to the lowest group id) and "zero" takes label 0. Both tie rules are
written out (``_first_argmin`` / ``_first_argmax``) instead of relying on a
library argmin's tie behaviour on each device.
"""

from __future__ import annotations

import numpy as np
import torch


def encode_ttfs(images: torch.Tensor, T: int,
                x_min: float = 1.0 / 255.0) -> torch.Tensor:
    """images (..., N_in) float in [0,1] -> spike times (..., N_in) int32 in
    [0, T]. T is the no-spike sentinel."""
    x = torch.clamp(torch.as_tensor(images, dtype=torch.float32), 0.0, 1.0)
    t = torch.floor((1.0 - x) * (T - 1)).to(torch.int32)
    return torch.where(x >= x_min, t, torch.full_like(t, T))


def frames_from_times(times: torch.Tensor, T: int) -> torch.Tensor:
    """(..., N) int32 spike times -> (..., T, N) int8 spike raster."""
    steps = torch.arange(T, dtype=torch.int32, device=times.device)
    return (times[..., None, :] == steps[:, None]).to(torch.int8)


def group_map(n_groups: int, per_group: int) -> np.ndarray:
    """Neuron -> group id for contiguous grouping (paper: 10 groups x 15)."""
    return np.repeat(np.arange(n_groups, dtype=np.int32), per_group)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis, ties to the first index, as int32."""
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    hit = x == x.amin(dim=-1, keepdim=True)
    return torch.where(hit, idx, x.shape[-1]).amin(dim=-1).to(torch.int32)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, ties to the first index, as int32."""
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.where(hit, idx, x.shape[-1]).amin(dim=-1).to(torch.int32)


def decode_labels(first_spike: torch.Tensor, v_final: torch.Tensor, *,
                  n_groups: int, per_group: int, sentinel: int,
                  fallback: str = "membrane") -> torch.Tensor:
    """Grouped TTFS readout -> (...,) int32 labels.

    first_spike: (..., G*P) int32 times (sentinel = no spike)
    v_final:     (..., G*P) int32 final membrane potentials (fallback evidence)
    """
    gmin = first_spike.reshape(first_spike.shape[:-1]
                               + (n_groups, per_group)).amin(dim=-1)
    ttfs_label = _first_argmin(gmin)
    any_spike = gmin.amin(dim=-1) < sentinel
    if fallback == "membrane":
        gv = v_final.reshape(v_final.shape[:-1]
                             + (n_groups, per_group)).amax(dim=-1)
        fb_label = _first_argmax(gv)
    elif fallback == "zero":
        fb_label = torch.zeros_like(ttfs_label)
    else:
        raise ValueError(f"unknown fallback {fallback!r}")
    return torch.where(any_spike, ttfs_label, fb_label)
