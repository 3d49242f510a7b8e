"""Deployment planner — the co-design analysis layer (paper Table 1 analogue).

The port of ``repro.core.codesign``. ``plan()`` runs at export time and its
outputs become the artifact's connectivity descriptor: how logical neurons
pack into 128-lane blocks (padding cost), whether the padded synapse matrix
and the neuron state fit the planning budget (the BRAM analogue), which
budget binds first and the largest layer the tiling can host.

The budget it plans against is ``ARTIFACT_PLAN_BUDGET``, a part of the
artifact format, not a device: ``deploy.export`` writes the plan's
``vmem_util`` and ``limiter`` into the artifact's ``codesign`` meta, which
the fingerprint hashes, so the port plans against exactly the numbers the
JAX exporter uses and the same model exports to the same artifact in both
packages. The runtimes read the padded layout from the artifact and never
re-plan it for the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hw import PYNQ_Z2
from repro_torch.core.quant import INT32_NEVER_FIRE


@dataclasses.dataclass(frozen=True)
class PlanBudget:
    """The budget an artifact's ``codesign`` meta is planned against."""

    lane: int          # block width: the padded layout's lane multiple
    vmem_bytes: int    # on-chip budget the weights and state must fit
    hbm_bytes: int     # at-rest budget for the artifact


#: Fixed by artifact format version 2 (the numbers of the JAX exporter's
#: planning target: lane 128, 32 MiB, 16 GiB), so that the same model
#: exports to the same fingerprint in both packages. They describe no device
#: the port runs on: the card's memory is not planned here.
ARTIFACT_PLAN_BUDGET = PlanBudget(lane=128, vmem_bytes=32 * 2**20,
                                  hbm_bytes=16 * 2**30)


@dataclasses.dataclass
class PlanReport:
    n_in: int
    n_out: int
    lane: int
    n_pad: int                 # padded output neurons (lane multiple)
    n_blocks: int              # hardware neuron blocks (the "group" analogue)
    pack_efficiency: float     # n_out / n_pad
    synapses: int              # logical synapse count
    synapses_padded: int
    w_bytes_vmem: int          # int8 padded weight bytes (on-chip resident)
    state_bytes_vmem: int      # membrane + first-spike + threshold (int32 x3)
    vmem_bytes_total: int
    vmem_util: float           # share of ARTIFACT_PLAN_BUDGET.vmem_bytes
    hbm_bytes: int             # artifact-at-rest (weights fp32+int8+meta)
    hbm_util: float            # share of ARTIFACT_PLAN_BUDGET.hbm_bytes
    limiter: str               # which budget binds first
    max_neurons_vmem: int      # largest n_out this n_in fits in the budget
    notes: str

    def table(self) -> str:
        """Render the Table-1 analogue. The budgets are the artifact
        format's planning budget, not the memory of a chip."""
        b = ARTIFACT_PLAN_BUDGET
        rows = [
            ("Neuron blocks (128-lane)", f"{self.n_blocks} "
             f"({self.n_out} logical -> {self.n_pad} padded, "
             f"{self.pack_efficiency:.1%} packed)"),
            ("Synapses (logical/padded)", f"{self.synapses:,} / {self.synapses_padded:,}"),
            ("On-chip weights (int8)", f"{self.w_bytes_vmem:,} B"),
            ("On-chip state (v/first/thr)", f"{self.state_bytes_vmem:,} B"),
            ("On-chip total / format budget", f"{self.vmem_bytes_total:,} B / "
             f"{b.vmem_bytes:,} B ({self.vmem_util:.2%})"),
            ("At rest / format budget", f"{self.hbm_bytes:,} B / "
             f"{b.hbm_bytes:,} B ({self.hbm_util:.4%})"),
            ("Primary limiter", self.limiter),
            ("Max neurons in budget @ n_in", f"{self.max_neurons_vmem:,}"),
            ("Paper reference (XC7Z020)", f"BRAM 140/140 (100%), "
             f"{PYNQ_Z2.packed_synapses:,} packed synapses — BRAM-limited"),
        ]
        w = max(len(k) for k, _ in rows)
        return "\n".join(f"{k:<{w}}  {v}" for k, v in rows)


def pad_to_lane(n: int, lane: int) -> int:
    return ((n + lane - 1) // lane) * lane


def plan(n_in: int, n_out: int) -> PlanReport:
    budget = ARTIFACT_PLAN_BUDGET
    lane = budget.lane
    n_pad = pad_to_lane(n_out, lane)
    n_blocks = n_pad // lane
    w_bytes = n_in * n_pad                       # int8
    state_bytes = 3 * 4 * n_pad                  # v, first_spike, thresholds int32
    vmem_total = w_bytes + state_bytes
    vmem_util = vmem_total / budget.vmem_bytes
    hbm_bytes = n_in * n_out * (4 + 1) + 4 * n_out + 4096   # fp32+int8 weights, thr, meta
    hbm_util = hbm_bytes / budget.hbm_bytes
    # the limiter strings are artifact meta (fingerprinted): they stay
    # JAX's words exactly
    limiter = "VMEM (on-chip memory — the BRAM analogue)" if vmem_util >= hbm_util \
        else "HBM capacity"
    if vmem_util < 0.01 and hbm_util < 0.01:
        limiter += " [ample headroom at this size]"
    max_neurons = (budget.vmem_bytes // (n_in + 12)) // lane * lane
    notes = ("event-processing path holds the padded int8 synapse matrix and all "
             "neuron state on chip, mirroring the paper's BRAM-resident design; "
             "off-chip memory holds the artifact at rest only.")
    return PlanReport(
        n_in=n_in, n_out=n_out, lane=lane, n_pad=n_pad, n_blocks=n_blocks,
        pack_efficiency=n_out / n_pad, synapses=n_in * n_out,
        synapses_padded=n_in * n_pad, w_bytes_vmem=w_bytes,
        state_bytes_vmem=state_bytes, vmem_bytes_total=vmem_total,
        vmem_util=vmem_util, hbm_bytes=hbm_bytes, hbm_util=hbm_util,
        limiter=limiter, max_neurons_vmem=int(max_neurons), notes=notes)


def blocked_layout(w_int8: np.ndarray, thresholds: np.ndarray, group_ids: np.ndarray,
                   lane: int = 128) -> dict[str, np.ndarray]:
    """Produce the padded block layout stored in the artifact (connectivity
    descriptor): columns padded to a lane multiple; dead lanes get a
    never-fire threshold and group id -1. Consumed by the accelerator runtime
    AND by the reference agreement tests (slicing [:n_out] recovers logical)."""
    n_in, n_out = w_int8.shape
    n_pad = pad_to_lane(n_out, lane)
    w_p = np.zeros((n_in, n_pad), np.int8)
    w_p[:, :n_out] = w_int8
    thr_p = np.full((n_pad,), INT32_NEVER_FIRE, np.int32)
    thr_p[:n_out] = thresholds
    gid_p = np.full((n_pad,), -1, np.int32)
    gid_p[:n_out] = group_ids
    block_table = np.stack([np.arange(n_pad // lane) * lane,
                            np.minimum(lane, np.maximum(
                                0, n_out - np.arange(n_pad // lane) * lane))],
                           axis=1).astype(np.int32)   # (n_blocks, [start, live])
    return {"w_padded": w_p, "thr_padded": thr_p, "gid_padded": gid_p,
            "block_table": block_table}
