"""Batched SNN serving engine — the synchronous facade over the scheduler.

The port of ``repro.serving.snn_engine``. ``SNNServeEngine`` keeps the
submit()/flush()/classify() surface and owns no serving logic: micro-
batching, the overflow→dense reroute and every stat live in
``serving.scheduler.ServingScheduler``.

Measurement discipline (the paper's §2.3 split):
  * accelerator-scope — device execution only, timed up to a
    ``torch.cuda.synchronize()`` on the program's device;
  * system-scope — everything a request pays: queueing, TTFS encode,
    host-side spike packing, micro-batching, the launch, readback.

Every batch is zero-padded to the engine's fixed ``max_batch``, so the
kernels always see one shape. On the accelerator, rows whose event frames
exceed the artifact's calibrated E_max are rerouted to the dense
time-batched path and counted; the board never drops an event (its FIFO
backpressures, costing cycles), so it never reroutes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.artifact import Artifact
from repro_torch.serving.scheduler import (ServeRequest, ServingError,
                                           ServingScheduler)

_BACKEND_SPECS = {"accelerator": "accelerator-event", "board": "board-batched"}
#: the kernel each backend runs when the caller names none
_DEFAULT_KERNELS = {"accelerator": "fused", "board": "torch"}


class SNNServeEngine:
    """Request-queue classifier serving: submit() → flush() → labels.

    ``backend`` selects the runtime behind the queue:

      * ``"accelerator"`` (default) serves the packed-event path; ``kernel``
        selects its implementation: ``"fused"`` (default, the hand-written
        event→LIF→decode CUDA kernels), ``"cuda"`` (the staged pipeline on
        the hand-written ``event_accum``, ``lif_fused`` and ``ttfs_decode``
        CUDA kernels) or ``"torch"`` (the staged plain-PyTorch pipeline);
      * ``"board"`` serves the board emulator's batched path; ``kernel``
        selects its full-T LIF: ``"torch"`` (default) or ``"cuda"`` (the
        hand-written ``lif_fused`` kernel). Every flush also accounts PL
        cycles and dynamic energy, surfaced in ``stats()`` as ``board_*``.

    An explicit kernel is forwarded to whichever backend is selected, so a
    board engine asked for the accelerator-only ``"fused"`` fails loudly.
    ``latency_mode`` serves with a per-row early exit at the first output
    spike (with the accelerator's ``"cuda"``, the exit scan runs in PyTorch
    between the two kernels, as the JAX package runs it in ``jnp``; the
    board's latency mode runs no kernel, as in the JAX package).

    ``workers=0`` (default) serves synchronously inside flush() — the
    deterministic facade mode; ``workers>=1`` hands the queue to that many
    continuous-batching worker lanes, each on a CUDA stream of its own on
    the card, and ``max_wait_us``, ``faults=``, ``resilience=`` and
    ``canary_pool=`` reach the scheduler as in the JAX package (see
    ``serving.scheduler``)."""

    def __init__(self, artifact: Artifact, *, max_batch: int = 64,
                 kernel: str | None = None, latency_mode: bool = False,
                 backend: str = "accelerator", workers: int = 0,
                 max_wait_us: float = 2000.0, faults=None, resilience=None,
                 canary_pool: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        if backend not in _BACKEND_SPECS:
            raise ValueError(f"unknown backend {backend!r}")
        self.art = artifact
        self.backend = backend
        self.max_batch = int(max_batch)
        self.latency_mode = bool(latency_mode)
        self.sched = ServingScheduler(
            artifact, spec=_BACKEND_SPECS[backend], workers=workers,
            max_batch=max_batch, max_wait_us=max_wait_us,
            kernel=_DEFAULT_KERNELS[backend] if kernel is None else kernel,
            latency_mode=latency_mode, faults=faults, resilience=resilience,
            canary_pool=canary_pool, device=device)
        self.accel = self.sched.lanes[0].runtime
        self._unclaimed: dict[int, ServeRequest] = {}

    # ----------------------------------------------------------------- queue
    def submit(self, image: np.ndarray) -> int:
        return self.sched.submit(image)

    def flush(self) -> dict[int, ServeRequest]:
        """Serve every queued request; returns {rid: completed request} for
        ALL completed-but-unclaimed requests."""
        done = self._unclaimed
        self._unclaimed = {}
        done.update(self.sched.drain())
        return done

    def classify(self, images: Sequence[np.ndarray] | np.ndarray
                 ) -> np.ndarray:
        """images (B, N_in) -> labels (B,) int32. Claims ONLY its own
        requests; anything else the flush completed stays for the next
        flush()."""
        rids = [self.submit(img) for img in np.asarray(images, np.float32)]
        done = self.flush()
        out = [done.pop(r) for r in rids]
        self._unclaimed.update(done)
        for r in out:
            if r.error is not None:
                raise ServingError(r)
        return np.asarray([r.label for r in out], np.int32)

    def close(self) -> None:
        self.sched.close()

    # ----------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero the counters (e.g. after a warm-up pass)."""
        self.sched.reset_stats()

    def stats(self) -> dict:
        return {"backend": self.backend, **self.sched.stats()}
