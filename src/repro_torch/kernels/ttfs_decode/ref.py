"""Plain PyTorch version of the grouped-TTFS decode kernel: the readout of
``core.ttfs.decode_labels``, the semantics of the Pallas kernel it replaces
(``repro/kernels/ttfs_decode/kernel.py``) and of ``csrc/ttfs_decode.cu``."""

from __future__ import annotations

import torch

from repro_torch.core.ttfs import decode_labels


def ttfs_decode_ref(first_spike: torch.Tensor, v_final: torch.Tensor, *,
                    n_groups: int, per_group: int, sentinel: int,
                    fallback: str = "membrane") -> torch.Tensor:
    """first_spike, v_final (B, G*P) int32 -> labels (B,) int32."""
    return decode_labels(first_spike, v_final, n_groups=n_groups,
                         per_group=per_group, sentinel=sentinel,
                         fallback=fallback)
