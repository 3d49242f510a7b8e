"""Full-test-set agreement harness — the paper's headline validation.

The port of ``repro.core.agreement``. The paper's strongest claim is that
all 10,000 board predictions match the software reference, across 5
repeated runs (50,000 image-run pairs, 0 mismatches). This module
reproduces that protocol as a THREE-WAY harness: the software reference,
the accelerator runtime(s) and the board emulator all consume the same
artifact; every non-reference runtime's decoded labels AND first-spike
times are compared elementwise against the reference, and mismatch counts
are reported. Runtimes are named by the port's registry specs
(``core.runtimes``), and every runtime runs on ``device``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.accelerator import SNNAccelerator
from repro_torch.core.artifact import Artifact
from repro_torch.core.reference import SNNReference
from repro_torch.core.runtimes import make_runtime


@dataclasses.dataclass
class AgreementReport:
    n_images: int
    runtimes: list[str]
    label_mismatches: dict[str, int]        # vs reference
    spike_time_mismatches: dict[str, int]   # vs reference
    accuracy: dict[str, float]
    exact_match: bool
    wall_s: float

    def summary(self) -> str:
        lines = [f"agreement over {self.n_images} images:"]
        for r in self.runtimes:
            if r == "reference":
                lines.append(f"  reference            acc={self.accuracy[r]:.4%}")
            else:
                lines.append(
                    f"  {r:<20} acc={self.accuracy[r]:.4%} "
                    f"label_mismatch={self.label_mismatches[r]} "
                    f"spike_time_mismatch={self.spike_time_mismatches[r]}")
        lines.append(f"  EXACT MATCH: {self.exact_match}  ({self.wall_s:.1f}s)")
        return "\n".join(lines)


def _run_chunked(fn: Callable, images: np.ndarray, chunk: int):
    outs = [fn(images[i:i + chunk]) for i in range(0, len(images), chunk)]
    labels = np.concatenate([o.labels.cpu().numpy() for o in outs])
    first = np.concatenate([o.first_spike.cpu().numpy() for o in outs])
    return labels, first


def full_agreement(artifact: Artifact, images: np.ndarray, labels: np.ndarray,
                   runtimes=("accelerator-batch", "accelerator-event",
                             "board"),
                   kernel: str = "torch", chunk: int = 1024, *,
                   device: str | torch.device = "cuda") -> AgreementReport:
    t0 = time.perf_counter()
    ref = SNNReference(artifact, device=device)
    ref_labels, ref_first = _run_chunked(ref.forward, images, chunk)
    acc = {"reference": float(np.mean(ref_labels == labels))}
    lmm, smm = {}, {}
    for rt in runtimes:
        runner = make_runtime(artifact, rt, kernel=kernel, device=device)
        a_labels, a_first = _run_chunked(runner.forward, images, chunk)
        lmm[rt] = int(np.sum(a_labels != ref_labels))
        smm[rt] = int(np.sum(np.any(a_first != ref_first, axis=-1)))
        acc[rt] = float(np.mean(a_labels == labels))
    exact = all(v == 0 for v in lmm.values()) and all(v == 0 for v in smm.values())
    return AgreementReport(
        n_images=len(images), runtimes=["reference", *runtimes],
        label_mismatches=lmm, spike_time_mismatches=smm, accuracy=acc,
        exact_match=exact, wall_s=time.perf_counter() - t0)


def repeatability(artifact: Artifact, images: np.ndarray, labels: np.ndarray,
                  runs: int = 5, chunk: int = 1024, *,
                  device: str | torch.device = "cuda") -> dict:
    """Paper §3.3: five repeated runs, 0/50,000 mismatches, stable accuracy.
    Determinism here is a *property* (same artifact, same integer ops), and
    this harness provides the evidence in the paper's own protocol: each run
    builds a fresh batch-mode accelerator and compares its labels with the
    first run's."""
    base = None
    accs = []
    mismatch_pairs = 0
    for _ in range(runs):
        accel = SNNAccelerator(artifact, mode="batch", device=device)
        a_labels, _ = _run_chunked(accel.forward, images, chunk)
        accs.append(float(np.mean(a_labels == labels)))
        if base is None:
            base = a_labels
        else:
            mismatch_pairs += int(np.sum(a_labels != base))
    return {"runs": runs, "image_run_pairs": runs * len(images),
            "mismatches": mismatch_pairs, "accuracy_per_run": accs,
            "accuracy_stable": len(set(np.round(accs, 6))) == 1}
