"""Accelerator runtime — the event-driven path, on the card.

The port of ``repro.core.accelerator``. It consumes the SAME deployment
artifact as the software reference and executes the padded block layout the
planner emitted:

  * ``mode="event"`` — packed (T, E_max) event-id frames drive per-step
    gathers of weight rows, so work scales with ACTIVE events.
  * ``mode="batch"`` — the time-batched path: the (T, N_in) spike raster is
    one exact integer product with the weights, then the LIF scan over the
    (T, N_pad) currents. The serving tier's dense fallback for rows that
    overflow E_max.

``kernel`` picks the implementation (the JAX package's ``jnp`` is
``torch`` here, its ``pallas`` is ``cuda``):

  * ``"fused"`` (event mode) — the hand-written event→LIF→decode CUDA
    kernels (``kernels.fused_event_lif``): full-T with the label computed on
    the card, or, in latency mode, a per-row early exit at the first output
    spike. The (B, T, N_pad) currents never exist.
  * ``"cuda"`` — the staged pipeline on the hand-written CUDA kernels, as
    the JAX ``pallas`` kernel runs it: ``event_accum`` (event mode) or
    ``spike_matmul`` (batch mode) writes the (B, T, N_pad) int32 currents,
    then ``lif_fused`` and ``ttfs_decode``. Latency mode replaces
    ``lif_fused`` by the per-row early-exit scan in PyTorch, as JAX runs
    ``lif_scan_early_exit`` in ``jnp``. No float32 weight copy is built;
    batch mode keeps the weights' K-major int8 copy, which the tensor cores
    read, in the program cache's bundle tier.
  * ``"torch"`` — the same staged pipeline in plain PyTorch (the kernels'
    plain versions); batch mode's product is float32 (exact; see
    ``core.reference``), with the weight copy in the program cache's bundle
    tier.

All paths are bit-exact against the reference. Execution parameters come
from the lowered program.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.events import EventFrames, pack_events_batched
from repro_torch.core.lif_dynamics import lif_scan, lif_scan_early_exit_rows
from repro_torch.core.lowering import (LoweredProgram, get_cache, lower,
                                       program_nbytes)
from repro_torch.core.reference import as_images, spike_currents
from repro_torch.core.types import SNNOutput, decode_output
from repro_torch.kernels.event_accum import ops as ea_ops
from repro_torch.kernels.event_accum.ref import event_accum_ref
from repro_torch.kernels.fused_event_lif import ops as fused
from repro_torch.kernels.lif import ops as lif_ops
from repro_torch.kernels.spike_matmul import ops as smm_ops
from repro_torch.kernels.ttfs_decode import ops as dec_ops
from repro_torch.telemetry import trace as ttrace

#: kernels each mode runs
KERNELS = {"event": ("torch", "fused", "cuda"), "batch": ("torch", "cuda")}


class SNNAccelerator:
    def __init__(self, artifact: Artifact | LoweredProgram,
                 mode: str = "batch", kernel: str = "torch", *,
                 device: str | torch.device = "cuda"):
        if mode not in KERNELS:
            raise ValueError(mode)
        if kernel == "pallas":
            raise ValueError(
                "kernel 'pallas' names the JAX package's TPU kernels; the "
                "port's staged kernels are kernel='cuda'")
        if kernel == "fused" and mode != "event":
            raise ValueError(
                "the fused kernel consumes packed event frames; use "
                "mode='event' (batch mode has its own GEMM pipeline)")
        if kernel not in KERNELS[mode]:
            raise ValueError(kernel)
        prog = lower(artifact, device=device)
        self.program = prog
        self.device = prog.device
        self.art = prog.artifact
        self.mode, self.kernel = mode, kernel
        self.T = prog.T
        self.x_min = prog.x_min
        self.leak_shift = prog.leak_shift
        self.e_max = prog.e_max
        self.n_out = prog.n_out
        self.w_padded = prog.w_padded          # (N_in, N_pad) int8
        self.thr_padded = prog.thr_padded      # (N_pad,) int32
        if mode == "batch":
            # the product's weight copy, made once per program: float32 for
            # the plain product, K-major int8 for the tensor-core kernel
            make = ((lambda: {"w_t": smm_ops.k_major(prog.w_padded)})
                    if kernel == "cuda" else
                    (lambda: {"w_f32": prog.w_padded.to(torch.float32)}))
            bundle, self.cache_hit = get_cache().bundle(
                ("accelerator", *prog.cache_key, mode, kernel), make,
                nbytes=program_nbytes(prog))
            if kernel == "cuda":
                self._w_t = bundle["w_t"]
            else:
                self._w_f32 = bundle["w_f32"]

    # ------------------------------------------------------------- pipelines
    def _decode(self, first: torch.Tensor, v: torch.Tensor, steps):
        """Labels of the logical lanes of (B, N_pad) first/v; the CUDA
        decode reads the ``[:, :n_out]`` slices in place."""
        first_l, v_l = first[:, :self.n_out], v[:, :self.n_out]
        plan = self.program.decode
        if self.kernel == "cuda":
            labels = dec_ops.ttfs_decode(
                first_l, v_l, n_groups=plan.n_groups,
                per_group=plan.per_group, sentinel=plan.sentinel,
                fallback=plan.fallback)
        else:
            labels = decode_output(first_l, v_l, plan)
        if steps is None:
            steps = torch.full_like(labels, self.T)
        return SNNOutput(labels, first_l, v_l, steps)

    def _staged(self, currents: torch.Tensor,
                latency_mode: bool) -> SNNOutput:
        """(B, T, N_pad) int32 currents -> LIF over their (T, B, N_pad) view
        (read in place) -> decode."""
        view = currents.movedim(1, 0)
        if latency_mode:
            res, steps = lif_scan_early_exit_rows(view, self.thr_padded,
                                                  self.leak_shift, self.T)
            return self._decode(res.first_spike, res.v_final, steps)
        if self.kernel == "cuda":
            res = lif_ops.lif_fused(view, self.thr_padded, self.leak_shift)
        else:
            res = lif_scan(view, self.thr_padded, self.leak_shift, self.T)
        return self._decode(res.first_spike, res.v_final, None)

    def _forward_batch(self, images: torch.Tensor) -> SNNOutput:
        times = ttfs.encode_ttfs(images, self.T, self.x_min)
        raster = ttfs.frames_from_times(times, self.T)         # (B, T, N_in)
        if self.kernel == "cuda":
            currents = smm_ops.spike_matmul(raster, self.w_padded,
                                            w_t=self._w_t)
        else:
            currents = spike_currents(raster, self._w_f32)     # (B, T, N_pad)
        return self._staged(currents, latency_mode=False)

    def _forward_event(self, frames: EventFrames,
                       latency_mode: bool) -> SNNOutput:
        ids, count = frames.ids, frames.count
        if self.kernel == "fused":
            if latency_mode:
                res, steps = fused.fused_event_lif_early_exit(
                    ids, count, self.w_padded, self.thr_padded,
                    self.leak_shift)
                return self._decode(res.first_spike, res.v_final, steps)
            plan = self.program.decode
            res, labels = fused.fused_event_lif_decode(
                ids, count, self.w_padded, self.thr_padded, self.leak_shift,
                n_out=self.n_out, n_groups=plan.n_groups,
                per_group=plan.per_group, fallback=plan.fallback)
            return SNNOutput(labels, res.first_spike[:, :self.n_out],
                             res.v_final[:, :self.n_out],
                             torch.full_like(labels, self.T))
        if self.kernel == "cuda":
            currents = ea_ops.event_accum(ids, self.w_padded)  # (B, T, N_pad)
        else:
            currents = event_accum_ref(ids, self.w_padded)
        return self._staged(currents, latency_mode)

    # -------------------------------------------------------------- frontend
    def forward(self, images=None, frames: EventFrames | None = None,
                latency_mode: bool = False,
                check_overflow: bool = True) -> SNNOutput:
        """Batch mode takes ``images``; event mode takes ``images`` (encoded
        and packed on the host here) or pre-packed ``frames``.
        ``check_overflow=False`` skips the overflow test for callers (the
        serving tier) that already read the host flag at pack time."""
        rec = ttrace.get()
        fwd = None
        if rec.enabled:
            B = (int(frames.ids.shape[0]) if frames is not None
                 else int(np.atleast_2d(np.asarray(images)).shape[0]))
            fwd = rec.begin("accel.forward", "system",
                            attrs={"mode": self.mode, "batch": B,
                                   "T": self.T,
                                   "latency": bool(latency_mode)},
                            meta={"kernel": self.kernel})
        try:
            if self.mode == "batch":
                if images is None:
                    raise ValueError("batch mode consumes dense images")
                kr = rec.begin("accel.kernel", "accel", trace=fwd.trace,
                               parent=fwd.sid) if fwd is not None else None
                out = self._forward_batch(as_images(images, self.device))
                rec.end(kr)
                return out
            if frames is None:
                pk = rec.begin("accel.pack", "system", trace=fwd.trace,
                               parent=fwd.sid,
                               attrs={"e_max": self.e_max}) \
                    if fwd is not None else None
                times = ttfs.encode_ttfs(as_images(images, "cpu"), self.T,
                                         self.x_min).numpy()
                frames = pack_events_batched(times, self.T, self.e_max,
                                             device=self.device)
                rec.end(pk)
            if check_overflow and bool(np.any(frames.overflow)):
                raise OverflowError(
                    "event frames exceed artifact E_max; re-export with "
                    "larger headroom or use the dense batch path")
            kr = rec.begin("accel.kernel", "accel", trace=fwd.trace,
                           parent=fwd.sid) if fwd is not None else None
            out = self._forward_event(frames, latency_mode)
            rec.end(kr)
            return out
        finally:
            rec.end(fwd)

    __call__ = forward
