"""AER input event queue — the board emulator's ingress stage.

The port of ``repro.board.event_queue``, host numpy as there. The FPGA
receives (neuron_id) address-event packets time-ordered by the TTFS encoder
and buffers them in a finite FIFO in front of the event router:

  * events are scheduled per tick from the TTFS spike times, ordered by
    ascending neuron id within a tick (the same (time, id) order the host
    packer in ``core.events`` produces: a stable argsort);
  * the FIFO has a finite ``depth`` (the artifact's calibrated E_max);
  * overflow NEVER drops events: the ingress backpressures, which costs
    stall cycles in the cost model but preserves semantics bit-exactly.
"""

from __future__ import annotations

import numpy as np


class AEREventQueue:
    """Per-image event schedule with FIFO-occupancy accounting.

    ``times``: (N_in,) int spike times, T = never-spikes sentinel.
    Iterating yields ``(t, ids_t)`` for t in [0, T) where ``ids_t`` is the
    int32 array of input neurons spiking at tick t, ascending.
    """

    def __init__(self, times: np.ndarray, T: int, depth: int):
        times = np.asarray(times)
        if times.ndim != 1:
            raise ValueError(f"AER queue schedules one image; got {times.shape}")
        self.T = int(T)
        self.depth = int(depth)
        order = np.argsort(times, kind="stable")       # (time, id) ascending
        sorted_t = times[order]
        valid = sorted_t < T
        self._ids = order[valid].astype(np.int32)
        self._splits = np.searchsorted(sorted_t[valid], np.arange(1, T))
        self.total_events = int(self._ids.size)

    def events_at(self, t: int) -> np.ndarray:
        lo = 0 if t == 0 else self._splits[t - 1]
        hi = self.total_events if t == self.T - 1 else self._splits[t]
        return self._ids[lo:hi]

    def __iter__(self):
        for t in range(self.T):
            yield t, self.events_at(t)

    def stalls_at(self, t: int) -> int:
        """Backpressure: events beyond FIFO depth in one tick stall ingress."""
        return max(0, len(self.events_at(t)) - self.depth)

    def counts(self) -> np.ndarray:
        """(T,) events per tick — the cost model's per-tick load."""
        return np.asarray([len(self.events_at(t)) for t in range(self.T)],
                          dtype=np.int64)
