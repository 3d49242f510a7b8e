"""Neutral output/plan types shared by every runtime family.

The port of ``repro.core.types``: the dependency floor of the runtime stack,
importing only ``core.ttfs``. ``SNNOutput`` holds tensors on the runtime's
device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import ttfs


class SNNOutput(NamedTuple):
    labels: torch.Tensor       # (B,) int32
    first_spike: torch.Tensor  # (B, N_out) int32 (logical neurons)
    v_final: torch.Tensor      # (B, N_out) int32
    steps: torch.Tensor        # (B,) int32 — timesteps consumed (T for full scan)


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """The lowered TTFS encode stage: everything the host packer needs."""

    T: int          # time window; also the never-spiked sentinel
    x_min: float    # encoder intensity threshold
    e_max: int      # calibrated event-buffer depth (FIFO depth analogue)
    n_in: int       # input neurons (admission-time shape contract)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The lowered grouped-TTFS readout stage (paper §2.3)."""

    n_groups: int   # class groups
    per_group: int  # neurons per group (n_groups * per_group == n_out)
    sentinel: int   # first-spike sentinel (== T)
    fallback: str   # "membrane" | "zero" no-spike policy


def decode_output(first_spike: torch.Tensor, v_final: torch.Tensor,
                  plan: DecodePlan) -> torch.Tensor:
    """Public grouped readout: (…, n_out) first-spike/membrane -> labels."""
    return ttfs.decode_labels(
        first_spike, v_final,
        n_groups=plan.n_groups, per_group=plan.per_group,
        sentinel=plan.sentinel, fallback=plan.fallback)
