"""Grouped neuron core — the PL microarchitecture's state and update rules.

The port of ``repro.board.neuron_core``, host numpy as there. 16 hardware
groups x 128 neurons (the paper's direct-addressing limit), each holding
int8 synapse rows and int32 membranes. The artifact's padded layout
(``w_padded``/``thr_padded``) maps onto the first ``n_pad / lane`` groups;
padded lanes carry a never-fire threshold, present but electrically dead.

Update rules are the integer LIF contract (``core.lif_dynamics``), evaluated
event by event:

    dispatch(event nid):  acc[g, :] += w[nid, g, :]          (all groups, int32)
    tick(t):              v <- v - (v >> leak_shift) + acc
                          fired = (v >= thr) & (first == T); latch first <- t

``>>`` on numpy int32 is an arithmetic shift, as the contract requires
(``leak_shift`` 31 leaks +1 a tick on a negative membrane). Integer addition
is associative, so per-event accumulation is bit-exact with the reference's
dense per-tick product.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.artifact import Artifact
from repro_torch.core.hw import PYNQ_COST, BoardCostModel


class GroupedNeuronCore:
    def __init__(self, w_padded: np.ndarray, thr_padded: np.ndarray,
                 leak_shift: int, T: int, cost: BoardCostModel = PYNQ_COST):
        n_in, n_pad = w_padded.shape
        if n_pad % cost.lane:
            raise ValueError(f"n_pad {n_pad} is not a multiple of the "
                             f"hardware lane width {cost.lane}")
        self.groups_used = n_pad // cost.lane
        if self.groups_used > cost.groups:
            raise ValueError(
                f"network needs {self.groups_used} hardware groups but the "
                f"board has {cost.groups} ({cost.neurons_direct} directly "
                f"addressable neurons — the paper's packing limit)")
        self.lane = cost.lane
        self.n_pad = n_pad
        self.T = int(T)
        self.leak_shift = int(leak_shift)
        # (N_in, G, lane): one row fetch serves every group in parallel
        self.w = np.ascontiguousarray(
            w_padded.reshape(n_in, self.groups_used, cost.lane)).astype(np.int8)
        self.thr = thr_padded.reshape(self.groups_used, cost.lane).astype(np.int32)
        self.reset()

    @classmethod
    def from_program(cls, program,
                     cost: BoardCostModel = PYNQ_COST) -> "GroupedNeuronCore":
        """Build from a lowered program (``core.lowering.LoweredProgram``) on
        any device. The core owns host copies of the program's padded
        weights and thresholds, so fault models may write ``core.thr``
        without touching the program's tensors."""
        return cls(program.w_padded.cpu().numpy(),
                   program.thr_padded.cpu().numpy(),
                   program.leak_shift, program.T, cost)

    @classmethod
    def from_artifact(cls, art: Artifact,
                      cost: BoardCostModel = PYNQ_COST) -> "GroupedNeuronCore":
        from repro_torch.core.lowering import lower
        return cls.from_program(lower(art, device="cpu"), cost)

    def reset(self) -> None:
        self.v = np.zeros((self.groups_used, self.lane), np.int32)
        self.first = np.full((self.groups_used, self.lane), self.T, np.int32)
        self._acc = np.zeros((self.groups_used, self.lane), np.int32)

    def dispatch(self, nid: int) -> None:
        """Route one AER event: its weight row accumulates into every group."""
        self._acc += self.w[nid].astype(np.int32)

    def tick(self, t: int) -> bool:
        """Close tick t: leak, integrate, fire. Returns True if any neuron
        fired at this tick (the TTFS decision signal)."""
        self.v = self.v - (self.v >> self.leak_shift) + self._acc
        fired = (self.v >= self.thr) & (self.first == self.T)
        self.first = np.where(fired, np.int32(t), self.first)
        self._acc = np.zeros_like(self._acc)
        return bool(fired.any())

    # flat (n_pad,) views for the decode stage / output contract
    @property
    def first_flat(self) -> np.ndarray:
        return self.first.reshape(self.n_pad)

    @property
    def v_flat(self) -> np.ndarray:
        return self.v.reshape(self.n_pad)
