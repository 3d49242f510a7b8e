"""Per-image board scheduler — the readable audit path of the emulator.

The port of ``repro.board.runtime``. ``SNNBoard`` consumes the SAME
deployment artifact as ``SNNReference`` and ``SNNAccelerator`` and executes
the paper's PL loop one image at a time, one tick at a time:

    TTFS encode -> AER queue -> per-tick event dispatch into the grouped
    neuron core -> leak/integrate/fire -> grouped TTFS first-spike decode

with every tick's cycle and energy cost accounted against the board cost
model. ``latency_mode=True`` stops at the tick of the first output spike
(the paper's TTFS decision point); the default full-T mode runs the whole
window, so first-spike times are bit-exact with the software reference on
all neurons.

Encoding and decoding run on the program's device and the returned
``SNNOutput`` tensors lie there; the tick loop between them is plain host
numpy, as in the JAX package. It models the FPGA's sequential scheduler: it
is the audit path, small, steppable and slow, not a served path.
``board.batched.SNNBoardBatched`` is the batched path held bit-exact
against it (outputs AND traces).

``faults=`` takes a dynamic fault plan (``faults.plan.FaultPlan``),
interpreted per image by the tick loop as in the JAX package: a forced FIFO
depth, stuck-at groups (``faults.models.apply_stuck`` on the core's host
thresholds), the glitching AER link (``FaultyAEREventQueue``) and membrane
upsets after each tick (``MembraneUpsetInjector``), each seeded by the row's
index in the batch. ``last_tick_counts`` and ``last_ecc`` record what the
trace and ECC detectors read. ``None`` or a clean plan leaves the datapath
bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.board.energy import BoardTrace, account, span_attrs, stack_traces
from repro_torch.board.event_queue import AEREventQueue
from repro_torch.board.neuron_core import GroupedNeuronCore
from repro_torch.core import ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.hw import PYNQ_COST, BoardCostModel
from repro_torch.core.lowering import LoweredProgram, lower
from repro_torch.core.reference import as_images
from repro_torch.core.types import SNNOutput, decode_output
from repro_torch.telemetry import trace as ttrace


class SNNBoard:
    def __init__(self, artifact: Artifact | LoweredProgram, *,
                 latency_mode: bool = False,
                 cost: BoardCostModel = PYNQ_COST, faults=None,
                 device: str | torch.device = "cuda"):
        prog = lower(artifact, device=device)
        self.program = prog
        self.device = prog.device
        self.art = prog.artifact
        self.cost = cost
        self.latency_mode = bool(latency_mode)
        self.T = prog.T
        self.x_min = prog.x_min
        self.n_out = prog.n_out
        self.depth = prog.e_max
        self.core = GroupedNeuronCore.from_program(prog, cost)
        self.n_pad = self.core.n_pad
        # dynamic fault plan, interpreted per image by the tick loop
        self.plan = faults
        self.stuck_groups: list[int] = []
        if faults is not None and faults.fifo_depth is not None:
            self.depth = int(faults.fifo_depth)
        if faults is not None and faults.stuck_groups:
            from repro_torch.faults.models import apply_stuck
            self.stuck_groups = apply_stuck(self.core, faults,
                                            n_out=self.n_out)
        self.last_trace: BoardTrace | None = None
        #: (B, T) events dispatched per tick in the last forward
        self.last_tick_counts: np.ndarray | None = None
        #: (B,) membrane parity hits in the last forward
        self.last_ecc: np.ndarray | None = None

    # ------------------------------------------------------------- one image
    def _make_queue(self, times: np.ndarray, image_key: int):
        if self.plan is not None and self.plan.has_aer_faults:
            from repro_torch.faults.models import FaultyAEREventQueue
            return FaultyAEREventQueue(times, self.T, self.depth, self.plan,
                                       image_key)
        return AEREventQueue(times, self.T, self.depth)

    def run_image(self, times: np.ndarray, image_key: int = 0
                  ) -> tuple[np.ndarray, np.ndarray, int, BoardTrace,
                             np.ndarray, int]:
        """times (N_in,) int spike times -> (first (n_pad,), v (n_pad,),
        ticks executed, trace, (T,) events dispatched per tick, membrane
        parity hits). ``image_key`` seeds the image's fault draws."""
        queue = self._make_queue(times, image_key)
        upset = None
        if self.plan is not None and self.plan.seu_membrane_rate:
            from repro_torch.faults.models import MembraneUpsetInjector
            upset = MembraneUpsetInjector(self.plan, image_key)
        core = self.core
        core.reset()
        events = stalls = 0
        ticks = self.T
        tick_counts = np.zeros(self.T, np.int64)
        for t, ids in queue:
            for nid in ids:
                core.dispatch(int(nid))
            tick_counts[t] = len(ids)
            events += len(ids)
            stalls += queue.stalls_at(t)
            fired = core.tick(t)
            if upset is not None:
                upset.after_tick(core, t)
            if self.latency_mode and fired:
                ticks = t + 1
                break
        trace = account(events, ticks, stalls, core.n_pad, self.cost)
        return (core.first_flat.copy(), core.v_flat.copy(), ticks, trace,
                tick_counts, upset.ecc_hits if upset is not None else 0)

    # ------------------------------------------------------------- batch API
    def forward(self, images) -> SNNOutput:
        # telemetry: the span tree (board.forward -> encode / run
        # [/ image x B] / decode, impl in META so the canonical form matches
        # the batched path's) is a projection of the cost-model account —
        # no-ops unless a Tracer is installed
        rec = ttrace.get()
        x = as_images(images, self.device)
        if x.dim() == 1:
            x = x[None]
        fwd = rec.begin("board.forward", "system",
                        attrs={"batch": int(x.shape[0]), "T": self.T},
                        meta={"impl": "board-py"}) if rec.enabled else None
        enc = rec.begin("board.encode", "system", trace=fwd.trace,
                        parent=fwd.sid,
                        attrs={"n_in": int(x.shape[1])}) \
            if fwd is not None else None
        times = ttfs.encode_ttfs(x, self.T, self.x_min).cpu().numpy()
        rec.end(enc)
        run = rec.begin("board.run", "accel", trace=fwd.trace,
                        parent=fwd.sid) if fwd is not None else None
        firsts, vs, steps, traces, tick_counts, eccs = [], [], [], [], [], []
        for key, row in enumerate(times):
            first, v, ticks, trace, counts, ecc = self.run_image(
                row, image_key=key)
            firsts.append(first[:self.n_out])
            vs.append(v[:self.n_out])
            steps.append(ticks)
            traces.append(trace)
            tick_counts.append(counts)
            eccs.append(ecc)
        first_l = torch.from_numpy(np.stack(firsts)).to(self.device)
        v_l = torch.from_numpy(np.stack(vs)).to(self.device)
        self.last_trace = stack_traces(traces)
        self.last_tick_counts = np.stack(tick_counts)
        self.last_ecc = np.asarray(eccs, np.int64)
        if run is not None:
            totals, per = span_attrs(self.last_trace)
            rec.end(run, attrs=totals)
            for a in per:
                rec.emit("board.image", "accel", trace=run.trace,
                         parent=run.sid, attrs=a)
        dec = rec.begin("board.decode", "accel", trace=fwd.trace,
                        parent=fwd.sid, attrs={"n_out": self.n_out}) \
            if fwd is not None else None
        labels = decode_output(first_l, v_l, self.program.decode)
        rec.end(dec)
        rec.end(fwd)
        return SNNOutput(labels=labels, first_spike=first_l, v_final=v_l,
                         steps=torch.tensor(steps, dtype=torch.int32,
                                            device=self.device))

    __call__ = forward
