"""Integer LIF dynamics — the single source of truth for both runtimes.

The port of ``repro.core.lif_dynamics``. Per timestep t (all int32):

    v      <- v - (v >> leak_shift) + I_t          # arithmetic shift leak
    fired  <- (v >= threshold) and (first == T)    # threshold compare
    first  <- t where fired else first             # first-spike latch

``first == T`` is the no-spike sentinel. torch's ``>>`` on int32 is an
arithmetic shift (rounds toward -inf), as the reference requires: with
``leak_shift = 31`` a negative membrane gains 1 per step (``v >> 31 == -1``).
The scans are Python loops over T, one vector step per timestep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LIFResult(NamedTuple):
    first_spike: torch.Tensor  # (..., N) int32, T = never fired
    v_final: torch.Tensor      # (..., N) int32


def lif_step(v: torch.Tensor, first: torch.Tensor, i_t: torch.Tensor,
             thresholds: torch.Tensor, leak_shift: int, t: int, T: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One timestep of the recurrence; returns the new ``(v, first)``."""
    v = v - (v >> leak_shift) + i_t
    fired = (v >= thresholds) & (first == T)
    return v, torch.where(fired, torch.full_like(first, t), first)


def lif_scan(currents: torch.Tensor, thresholds: torch.Tensor,
             leak_shift: int, T: int, return_v_history: bool = False):
    """currents: (T, ..., N) int32 synaptic input per step.

    With ``return_v_history=True`` returns ``(LIFResult, vs)`` where
    ``vs[t]`` (a (T, ..., N) tensor) is the membrane AFTER step t."""
    v = torch.zeros(currents.shape[1:], dtype=torch.int32,
                    device=currents.device)
    first = torch.full_like(v, T)
    history = []
    for t in range(T):
        v, first = lif_step(v, first, currents[t], thresholds, leak_shift,
                            t, T)
        if return_v_history:
            history.append(v)
    res = LIFResult(first_spike=first, v_final=v)
    return (res, torch.stack(history)) if return_v_history else res


def lif_scan_early_exit(currents: torch.Tensor, thresholds: torch.Tensor,
                        leak_shift: int, T: int
                        ) -> tuple[LIFResult, torch.Tensor]:
    """Latency mode: stop integrating once ANY neuron of ``currents`` has
    fired (the whole tensor — call it per example for per-row exits).

    Returns (LIFResult, steps executed as a 0-d int32 tensor). ``v_final``
    is the membrane AT EXIT TIME; labels decoded from the result equal the
    full scan's (see ``repro.core.lif_dynamics.lif_scan_early_exit``)."""
    v = torch.zeros(currents.shape[1:], dtype=torch.int32,
                    device=currents.device)
    first = torch.full_like(v, T)
    t = 0
    while t < T and bool(torch.all(first == T)):
        v, first = lif_step(v, first, currents[t], thresholds, leak_shift,
                            t, T)
        t += 1
    return (LIFResult(first_spike=first, v_final=v),
            torch.tensor(t, dtype=torch.int32, device=currents.device))


def lif_scan_early_exit_rows(currents: torch.Tensor, thresholds: torch.Tensor,
                             leak_shift: int, T: int
                             ) -> tuple[LIFResult, torch.Tensor]:
    """``lif_scan_early_exit`` per row, as ``jax.vmap`` runs it over a batch:
    currents (T, B, N); all rows advance together, and each row freezes its
    v, first and step count once any of its N lanes has fired. Nothing is
    read back to the host inside the loop, which always runs T steps.

    Returns (LIFResult over (B, N) with v at each row's exit, steps (B,)
    int32)."""
    v = torch.zeros(currents.shape[1:], dtype=torch.int32,
                    device=currents.device)
    first = torch.full_like(v, T)
    steps = torch.zeros(currents.shape[1:2], dtype=torch.int32,
                        device=currents.device)
    for t in range(T):
        live = (first == T).all(dim=-1)                     # (B,)
        v_t, first_t = lif_step(v, first, currents[t], thresholds,
                                leak_shift, t, T)
        v = torch.where(live[:, None], v_t, v)
        first = torch.where(live[:, None], first_t, first)
        steps += live.to(torch.int32)
    return LIFResult(first_spike=first, v_final=v), steps
