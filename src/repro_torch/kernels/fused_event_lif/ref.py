"""Plain PyTorch versions of the fused event→LIF→decode kernels.

The same recurrence the CUDA kernels run (``csrc/fused_event_lif.cu``), and
the semantics of the Pallas kernels they replace
(``repro/kernels/fused_event_lif/kernel.py``): per timestep, sum the int8
weight rows of the step's first ``count[b, t]`` event ids, skipping PAD
(negative) ids, into an int32 current; then the LIF update and first-spike
latch of ``core.lif_dynamics``. On the CPU the wrappers in ``ops`` run
these; on the card ``chip_smoke.py`` holds each kernel against them.

The T-loop is a Python loop with one (B, E_max, N_pad) int8 gather per step,
so the (B, T, N_pad) currents tensor is never materialized: the weight
matrix gets one zero row and every skipped slot points at it. With
``chunk=C`` (tests only) the full-T and early-exit versions follow the CUDA
kernels' order of work instead: the currents of C steps are gathered before
those steps are scanned, and an early exit drops what was gathered past it.
"""

from __future__ import annotations

import torch

from repro_torch.core import ttfs
from repro_torch.core.lif_dynamics import lif_step


def _slot_rows(ids: torch.Tensor, count: torch.Tensor, n_in: int
               ) -> torch.Tensor:
    """ids (B, T, E) -> row index per slot: the id for a live event, ``n_in``
    (the zero row) for PAD and for slots at or past ``count[b, t]``."""
    E = ids.shape[-1]
    slot = torch.arange(E, device=ids.device)
    live = (ids >= 0) & (slot < count[..., None])
    return torch.where(live, ids.long(), n_in)


def _augment(w: torch.Tensor) -> torch.Tensor:
    """(N_in, N_pad) int8 -> (N_in + 1, N_pad) with a zero row."""
    return torch.cat([w, w.new_zeros((1, w.shape[1]))], dim=0)


def _step_currents(rows_t: torch.Tensor, w_aug: torch.Tensor) -> torch.Tensor:
    """rows_t (..., E) row indices -> (..., N_pad) int32 currents."""
    return w_aug[rows_t].sum(dim=-2, dtype=torch.int32)


def _currents(rows: torch.Tensor, w_aug: torch.Tensor, chunk: int | None):
    """Yield (t, (B, N_pad) currents of step t): one step gathered at a time,
    or, with ``chunk``, the steps of each chunk gathered together first."""
    T = rows.shape[1]
    for t0 in range(0, T, chunk or 1):
        gathered = _step_currents(rows[:, t0:t0 + (chunk or 1)], w_aug)
        for c in range(gathered.shape[1]):
            yield t0 + c, gathered[:, c]


def fused_event_lif_ref(ids: torch.Tensor, count: torch.Tensor,
                        w: torch.Tensor, thresholds: torch.Tensor,
                        leak_shift: int, *, chunk: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """ids (B, T, E_max) int32, count (B, T) int32, w (N_in, N_pad) int8,
    thresholds (N_pad,) int32 -> (first_spike, v_final), (B, N_pad) int32."""
    B, T, _ = ids.shape
    rows = _slot_rows(ids, count, w.shape[0])
    w_aug = _augment(w)
    v = torch.zeros((B, w.shape[1]), dtype=torch.int32, device=w.device)
    first = torch.full_like(v, T)
    for t, i_t in _currents(rows, w_aug, chunk):
        v, first = lif_step(v, first, i_t, thresholds, leak_shift, t, T)
    return first, v


def fused_event_lif_decode_ref(ids: torch.Tensor, count: torch.Tensor,
                               w: torch.Tensor, thresholds: torch.Tensor,
                               leak_shift: int, *, n_out: int, n_groups: int,
                               per_group: int, fallback: str = "membrane"
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The full-T pass plus the grouped-TTFS decode of the logical lanes
    ``[:n_out]`` -> (first_spike, v_final (B, N_pad), labels (B,))."""
    first, v = fused_event_lif_ref(ids, count, w, thresholds, leak_shift)
    labels = ttfs.decode_labels(first[:, :n_out], v[:, :n_out],
                                n_groups=n_groups, per_group=per_group,
                                sentinel=ids.shape[1], fallback=fallback)
    return first, v, labels


def fused_event_lif_early_exit_ref(ids: torch.Tensor, count: torch.Tensor,
                                   w: torch.Tensor, thresholds: torch.Tensor,
                                   leak_shift: int, *, chunk: int | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Latency mode: each row integrates until ANY of its N_pad lanes has
    fired -> (first_spike, v at exit (B, N_pad), steps (B,)) int32; the
    contract of ``core.lif_dynamics.lif_scan_early_exit`` per row."""
    B, T, _ = ids.shape
    rows = _slot_rows(ids, count, w.shape[0])
    w_aug = _augment(w)
    v = torch.zeros((B, w.shape[1]), dtype=torch.int32, device=w.device)
    first = torch.full_like(v, T)
    steps = torch.zeros((B,), dtype=torch.int32, device=w.device)
    active = torch.ones((B,), dtype=torch.bool, device=w.device)
    for t, i_t in _currents(rows, w_aug, chunk):
        if not bool(active.any()):
            break
        v_t, first_t = lif_step(v, first, i_t, thresholds, leak_shift, t, T)
        v = torch.where(active[:, None], v_t, v)
        first = torch.where(active[:, None], first_t, first)
        steps += active.to(torch.int32)
        active &= (first == T).all(dim=1)
    return first, v, steps
