"""Cycle and dynamic-energy accounting for the board emulator.

The port of ``repro.board.energy``. One ``account`` function shared by the
per-image scheduler and the batched path: the same expression evaluated on
python ints or on (B,) numpy arrays, so the two paths cannot drift apart.
The account stays on the host in numpy int64 / float64, exactly as the JAX
package computes it; the golden ``board_energy_nj`` are float64 and are
compared with ``==``.

The model terms live on ``core.hw.BoardCostModel``; this module only does
the bookkeeping:

    cycles = fixed + events*c_event + ticks*c_tick + stalls*c_stall + decode
    nJ     = (events*pj_event + events*n_pad*pj_synop
              + ticks*n_pad*pj_neuron_tick + pj_decode) * 1e-3

(``* 1e-3``, as the code has always written it: ``/ 1000`` rounds
differently in float64.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hw import PYNQ_COST, BoardCostModel


@dataclasses.dataclass
class BoardTrace:
    """Per-image datapath account. Fields are (B,) arrays (batched) or the
    same expressions evaluated per image and stacked — identical either way."""

    ticks: np.ndarray        # ticks executed (T, or first-spike tick + 1)
    events: np.ndarray       # AER events dispatched within the executed window
    stalls: np.ndarray       # FIFO backpressure events (depth exceeded)
    synops: np.ndarray       # int8 synaptic accumulates (events * n_pad)
    cycles: np.ndarray       # total PL cycles
    energy_nj: np.ndarray    # dynamic energy estimate

    def us(self, clock_hz: float = PYNQ_COST.clock_hz) -> np.ndarray:
        """Modelled PL latency per image (cycles at the board's clock)."""
        return self.cycles / clock_hz * 1e6

    def summary(self, clock_hz: float = PYNQ_COST.clock_hz) -> str:
        return (f"cycles/img {float(np.mean(self.cycles)):.1f}  "
                f"({float(np.mean(self.us(clock_hz))):.4f} us @ "
                f"{clock_hz / 1e6:.0f} MHz)  "
                f"nJ/img {float(np.mean(self.energy_nj)):.1f}  "
                f"events/img {float(np.mean(self.events)):.1f}  "
                f"ticks/img {float(np.mean(self.ticks)):.1f}")


def account(events, ticks, stalls, n_pad: int,
            cost: BoardCostModel = PYNQ_COST) -> BoardTrace:
    """Evaluate the cost model. ``events``/``ticks``/``stalls`` may be python
    ints (one image) or int64 arrays (a batch); n_pad is the populated lane
    count (synapse row width — padded lanes still clock, as on the board)."""
    events = np.asarray(events, np.int64)
    ticks = np.asarray(ticks, np.int64)
    stalls = np.asarray(stalls, np.int64)
    synops = events * n_pad
    cycles = (cost.cycles_fixed
              + events * cost.cycles_per_event
              + ticks * cost.cycles_per_tick
              + stalls * cost.cycles_per_stall
              + cost.cycles_decode)
    energy_nj = (events * cost.pj_per_event
                 + synops * cost.pj_per_synop
                 + ticks * (n_pad * cost.pj_per_neuron_tick)
                 + cost.pj_per_decode) * 1e-3
    return BoardTrace(ticks=ticks, events=events, stalls=stalls,
                      synops=synops, cycles=cycles,
                      energy_nj=np.asarray(energy_nj, np.float64))


def span_attrs(trace: BoardTrace) -> tuple[dict, list[dict]]:
    """Project a (B,)-array trace into telemetry span attributes: the
    ``board.run`` totals and one ``board.image`` attr dict per image. All
    values are logical clocks (cost-model integers and the derived energy),
    so the spans are deterministic for a seeded run and equal between the
    per-image scheduler and the batched path."""
    ticks = np.atleast_1d(np.asarray(trace.ticks, np.int64))
    events = np.atleast_1d(np.asarray(trace.events, np.int64))
    stalls = np.atleast_1d(np.asarray(trace.stalls, np.int64))
    synops = np.atleast_1d(np.asarray(trace.synops, np.int64))
    cycles = np.atleast_1d(np.asarray(trace.cycles, np.int64))
    energy = np.atleast_1d(np.asarray(trace.energy_nj, np.float64))
    totals = {"events": int(events.sum()), "ticks": int(ticks.sum()),
              "stalls": int(stalls.sum()), "synops": int(synops.sum()),
              "cycles": int(cycles.sum()), "energy_nj": float(energy.sum())}
    per = [{"i": i, "events": int(events[i]), "ticks": int(ticks[i]),
            "stalls": int(stalls[i]), "synops": int(synops[i]),
            "cycles": int(cycles[i]), "energy_nj": float(energy[i])}
           for i in range(len(cycles))]
    return totals, per


def stack_traces(traces: list[BoardTrace]) -> BoardTrace:
    """Stack per-image scalar traces into one (B,)-array trace."""
    return BoardTrace(*(np.stack([np.asarray(getattr(tr, f.name))
                                  for tr in traces])
                        for f in dataclasses.fields(BoardTrace)))
