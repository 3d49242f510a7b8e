"""Plain PyTorch version of the event-accumulation kernel.

The semantics of the Pallas kernel it replaces
(``repro/kernels/event_accum/kernel.py``) and of ``csrc/event_accum.cu``:
per step row, the int32 sum of the int8 weight rows of every slot's id,
where a slot whose id lies outside ``[0, N_in)`` (PAD = -1, wherever it sits
in the row) adds nothing. One (..., E_max, N_pad) int8 gather: the weight
matrix gets one zero row and every skipped slot points at it.
"""

from __future__ import annotations

import torch


def event_accum_ref(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ids (..., E_max) int32, w (N_in, N_pad) int8 -> (..., N_pad) int32."""
    n_in = w.shape[0]
    live = (ids >= 0) & (ids < n_in)
    rows = torch.where(live, ids.long(), n_in)
    w_aug = torch.cat([w, w.new_zeros((1, w.shape[1]))], dim=0)
    return w_aug[rows].sum(dim=-2, dtype=torch.int32)
