"""Packed event buffers — the replacement for AER packets.

The port of ``repro.core.events``. Per batch row, the frames hold

    ids   (T, E_max) int32   neuron ids spiking at step t, padded with PAD (-1)
    count (T,)       int32   number of valid events per step

E_max is part of the deployment artifact (the event router's FIFO depth);
a row with more events in one step than E_max is flagged in ``overflow`` so
the serving tier can reroute it to the dense path.

Packing runs on the host in numpy; ``ids`` and ``count`` are written into
ONE int32 buffer that moves to the device in a single copy. ``overflow``
stays a host numpy array: the serving tier reads it without a device round
trip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD = -1


@dataclasses.dataclass
class EventFrames:
    ids: torch.Tensor        # (B, T, E_max) int32, PAD-padded
    count: torch.Tensor      # (B, T) int32
    overflow: np.ndarray     # (B,) bool, host — any step dropped events

    @property
    def e_max(self) -> int:
        return self.ids.shape[-1]


def step_counts(times: np.ndarray, T: int) -> np.ndarray:
    """(B, N) int spike times -> (B, T+1) events per step (bin T absorbs the
    never-spikes sentinel). One flat bincount: O(B*N), no python loop over T."""
    B, N = times.shape
    clipped = np.minimum(times, T).astype(np.int64)
    flat = np.arange(B, dtype=np.int64)[:, None] * (T + 1) + clipped
    return np.bincount(flat.ravel(), minlength=B * (T + 1)).reshape(B, T + 1)


def pack_events_batched(times: np.ndarray, T: int, e_max: int,
                        device: str | torch.device) -> EventFrames:
    """(B, N) host spike times (T = never) -> packed frames on ``device``.

    Vectorized (no python loop over batch or time): an argsort by (time, id)
    with a stable sort makes the packing deterministic and equal to
    ``repro.core.events.pack_events_batched``."""
    times = np.asarray(times)
    B, N = times.shape
    order = np.argsort(times, axis=1, kind="stable")          # (B, N) ids sorted by time
    sorted_t = np.take_along_axis(times, order, axis=1)       # (B, N)
    # position of each event within its timestep: exclusive cumsum of per-step
    # counts gives step_start[:, t] = #events with time < t
    counts = step_counts(times, T)
    step_start = np.zeros((B, T + 1), dtype=np.int64)
    np.cumsum(counts[:, :T], axis=1, out=step_start[:, 1:])
    n_ids = B * T * e_max
    buf = np.empty(n_ids + B * T, dtype=np.int32)
    ids = buf[:n_ids].reshape(B, T, e_max)
    ids.fill(PAD)
    buf[n_ids:] = np.minimum(counts[:, :T], e_max).ravel()
    overflow = np.any(counts[:, :T] > e_max, axis=1)
    pos_in_step = np.arange(N)[None, :] - np.take_along_axis(
        step_start, np.minimum(sorted_t, T).astype(np.int64), axis=1)
    valid = (sorted_t < T) & (pos_in_step < e_max)
    b_idx, n_idx = np.nonzero(valid)
    t_idx = sorted_t[b_idx, n_idx]
    e_idx = pos_in_step[b_idx, n_idx]
    ids[b_idx, t_idx, e_idx] = order[b_idx, n_idx].astype(np.int32)
    dev = torch.from_numpy(buf).to(device)                    # the one copy
    return EventFrames(ids=dev[:n_ids].view(B, T, e_max),
                       count=dev[n_ids:].view(B, T), overflow=overflow)


def calibrate_e_max(times: np.ndarray, T: int, lane: int = 128,
                    headroom: float = 1.0) -> int:
    """Pick E_max from calibration data: max simultaneous events per step,
    scaled by headroom, rounded up to a lane multiple. Stored in the artifact."""
    times = np.asarray(times)
    peak = int(step_counts(times, T)[:, :T].max()) if T > 0 else 0
    e = int(np.ceil(peak * headroom))
    return max(lane, ((e + lane - 1) // lane) * lane)
