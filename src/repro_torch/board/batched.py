"""Batched board emulator — the served, full-test-set path.

The port of ``repro.board.batched``. Same microarchitectural semantics as
``board.runtime.SNNBoard`` (the per-image scheduler), evaluated a batch at a
time on the program's device:

  * currents: the {0,1} spike raster times the padded int8 weights, the
    exact float32 product of ``core.reference.spike_currents`` (the JAX
    package computes it with ``dot_general`` outside any Pallas kernel), on
    a float32 copy of ``w_padded`` kept in the program cache's bundle tier;
  * full-T LIF: ``kernel="cuda"`` launches the hand-written ``lif_fused``
    kernel (``kernels.lif``, ``csrc/lif.cu``) on the currents' (T, B, N_pad)
    ``movedim`` view, read in place; ``kernel="torch"`` runs ``lif_scan``;
  * latency mode, either kernel: ``lif_scan`` with its membrane history, the
    membrane gathered at each row's exit tick and spikes after it masked,
    as the scheduler stops. The JAX package runs no Pallas kernel in this
    mode, so neither does the port;
  * the cycle/energy trace is computed on the host from the per-tick event
    counts (``core.events.step_counts``) through ``board.energy.account``.

Labels, first-spike times, membranes, steps AND the traces are identical to
the per-image scheduler's in both modes. The JAX package's kernel names
(``"jnp"``, ``"pallas"``) and the accelerator's ``"fused"`` raise
``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.board.energy import BoardTrace, account, span_attrs
from repro_torch.core import ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.events import step_counts
from repro_torch.core.hw import PYNQ_COST, BoardCostModel
from repro_torch.core.lif_dynamics import lif_scan
from repro_torch.core.lowering import (LoweredProgram, get_cache, lower,
                                       program_nbytes)
from repro_torch.core.reference import as_images, spike_currents
from repro_torch.core.types import SNNOutput, decode_output
from repro_torch.kernels.lif import ops as lif_ops
from repro_torch.telemetry import trace as ttrace

#: the LIF implementations of the batched board
KERNELS = ("torch", "cuda")


class SNNBoardBatched:
    def __init__(self, artifact: Artifact | LoweredProgram, *,
                 latency_mode: bool = False, kernel: str = "torch",
                 cost: BoardCostModel = PYNQ_COST,
                 device: str | torch.device = "cuda"):
        if kernel not in KERNELS:
            raise ValueError(
                f"board kernel {kernel!r} not supported (use 'torch' or "
                f"'cuda' — registry specs 'board-batched-torch' / "
                f"'board-batched-cuda'; 'jnp' and 'pallas' name the JAX "
                f"package's kernels, 'fused' is an accelerator-family "
                f"kernel)")
        prog = lower(artifact, device=device)
        self.program = prog
        self.device = prog.device
        self.art = prog.artifact
        self.cost = cost
        self.kernel = kernel
        self.latency_mode = bool(latency_mode)
        self.T = prog.T
        self.x_min = prog.x_min
        self.n_out = prog.n_out
        self.depth = prog.e_max
        n_pad = prog.n_pad
        if n_pad % cost.lane:
            raise ValueError(f"n_pad {n_pad} not lane-aligned ({cost.lane})")
        self.groups_used = n_pad // cost.lane
        if self.groups_used > cost.groups:
            raise ValueError(f"network needs {self.groups_used} groups; the "
                             f"board has {cost.groups}")
        self.n_pad = n_pad
        self.thr_padded = prog.thr_padded                       # (N_pad,)
        bundle, self.cache_hit = get_cache().bundle(
            ("board-batched", *prog.cache_key),
            lambda: {"w_f32": prog.w_padded.to(torch.float32)},
            nbytes=program_nbytes(prog))
        self._w_f32 = bundle["w_f32"]                           # (N_in, N_pad)
        self.last_trace: BoardTrace | None = None
        #: (B, T) events dispatched per tick in the last forward
        self.last_tick_counts: np.ndarray | None = None

    # ------------------------------------------------------------ device core
    def _run(self, times: torch.Tensor):
        """times (B, N_in) int32 -> (first_l, v_l, steps) on the device."""
        T, n_out = self.T, self.n_out
        raster = ttfs.frames_from_times(times, T)               # (B, T, N_in)
        currents = spike_currents(raster, self._w_f32).movedim(1, 0)
        B = currents.shape[1]
        if self.latency_mode:
            # TTFS decision point: stop at the first output spike. Gather the
            # membrane at each row's exit tick and mask spikes the scheduler
            # never saw — identical to the per-image early stop.
            res, vs = lif_scan(currents, self.thr_padded,
                               self.program.leak_shift, T,
                               return_v_history=True)
            first_l = res.first_spike[:, :n_out]
            t_first = first_l.amin(dim=1)                       # (B,)
            steps = torch.where(t_first < T, t_first + 1,
                                torch.full_like(t_first, T))
            rows = torch.arange(B, device=currents.device)
            v_l = vs[(steps - 1).long(), rows][:, :n_out]
            first_l = torch.where(first_l <= t_first[:, None], first_l,
                                  torch.full_like(first_l, T))
            return first_l, v_l, steps.to(torch.int32)
        if self.kernel == "cuda":
            res = lif_ops.lif_fused(currents, self.thr_padded,
                                    self.program.leak_shift)
        else:
            res = lif_scan(currents, self.thr_padded, self.program.leak_shift,
                           T)
        steps = torch.full((B,), T, dtype=torch.int32, device=currents.device)
        return res.first_spike[:, :n_out], res.v_final[:, :n_out], steps

    # ------------------------------------------------------------- host front
    def forward(self, images) -> SNNOutput:
        # telemetry: the same canonical span tree as the per-image scheduler
        # (board.forward -> encode / run [/ image x B] / decode); the decode
        # span is a zero-wall marker here, and the canonical form is
        # identical because both paths project the same trace account
        rec = ttrace.get()
        x = as_images(images, self.device)
        if x.dim() == 1:
            x = x[None]
        fwd = rec.begin("board.forward", "system",
                        attrs={"batch": int(x.shape[0]), "T": self.T},
                        meta={"impl": "board-batched"}) if rec.enabled else None
        enc = rec.begin("board.encode", "system", trace=fwd.trace,
                        parent=fwd.sid,
                        attrs={"n_in": int(x.shape[1])}) \
            if fwd is not None else None
        times = ttfs.encode_ttfs(x, self.T, self.x_min)
        rec.end(enc)
        run = rec.begin("board.run", "accel", trace=fwd.trace,
                        parent=fwd.sid) if fwd is not None else None
        first_l, v_l, steps = self._run(times)
        labels = decode_output(first_l, v_l, self.program.decode)
        # the trace, on the host: cumulative events and excess over the FIFO
        # depth up to each row's executed tick
        times_np = times.cpu().numpy()
        B = times_np.shape[0]
        steps_np = (steps.cpu().numpy().astype(np.int64) if self.latency_mode
                    else np.full(B, self.T, np.int64))
        counts = step_counts(times_np, self.T)[:, :self.T].astype(np.int64)
        self.last_tick_counts = counts
        cum = np.zeros((B, self.T + 1), np.int64)
        np.cumsum(counts, axis=1, out=cum[:, 1:])
        excess = np.maximum(counts - self.depth, 0)
        cum_x = np.zeros_like(cum)
        np.cumsum(excess, axis=1, out=cum_x[:, 1:])
        idx = np.arange(B)
        self.last_trace = account(cum[idx, steps_np], steps_np,
                                  cum_x[idx, steps_np], self.n_pad, self.cost)
        if run is not None:
            totals, per = span_attrs(self.last_trace)
            rec.end(run, attrs=totals)
            for a in per:
                rec.emit("board.image", "accel", trace=run.trace,
                         parent=run.sid, attrs=a)
            rec.emit("board.decode", "accel", trace=fwd.trace,
                     parent=fwd.sid, attrs={"n_out": self.n_out})
        rec.end(fwd)
        return SNNOutput(labels=labels, first_spike=first_l, v_final=v_l,
                         steps=steps)

    __call__ = forward
