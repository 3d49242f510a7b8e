"""Software reference runner — consumes the deployment artifact unchanged.

The port of ``repro.core.reference``: a straightforward dense time-loop
evaluation of the integer LIF/TTFS semantics, the oracle every other runtime
is held against bit for bit.

The per-step synaptic currents are an integer product of the {0,1} spike
raster and the int8 weights. torch has no exact int32 GEMM on the card
(``int8 @ int8`` wraps to int8), so the product runs in float32 and is cast
back to int32: every partial sum is an integer of magnitude at most
127 * K, exact in float32 while that stays below 2**24. Wider inputs are
split over K in slices of at most ``MAX_EXACT_N_IN`` rows, each an exact
float32 product, whose int32 partial sums are added (at MNIST's n_in of 784
one slice, one product). The reference sets
``torch.backends.cuda.matmul.allow_tf32 = False`` for this product, so the
float32 GEMM runs in full float32.

The float32 weight copy lives in the program cache's bundle tier, so two
``SNNReference`` instances over one program on one device share it. The
dense FP32/INT8 baselines of the JAX reference are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.lif_dynamics import lif_scan
from repro_torch.core.lowering import (MAX_EXACT_N_IN, LoweredProgram,
                                       get_cache, lower, program_nbytes)
from repro_torch.core.types import SNNOutput, decode_output


def spike_currents(raster: torch.Tensor, w_f32: torch.Tensor) -> torch.Tensor:
    """(B, T, N_in) {0,1} raster x (N_in, N) integer-valued float32 weights
    -> (B, T, N) int32 currents, exact (see the module docstring)."""
    if w_f32.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    x = raster.to(torch.float32)
    out = None
    for k0 in range(0, w_f32.shape[0], MAX_EXACT_N_IN):
        part = torch.matmul(x[..., k0:k0 + MAX_EXACT_N_IN],
                            w_f32[k0:k0 + MAX_EXACT_N_IN]).to(torch.int32)
        out = part if out is None else out + part
    return out


def as_images(images, device: torch.device) -> torch.Tensor:
    """Any array-like batch of images -> float32 tensor on ``device``."""
    return torch.as_tensor(images, dtype=torch.float32).to(device)


class SNNReference:
    """Reference runtime. ``forward(images)`` mirrors torch's ``model(x)``."""

    def __init__(self, artifact: Artifact | LoweredProgram, *,
                 device: str | torch.device = "cuda"):
        prog = lower(artifact, device=device)
        self.program = prog
        self.device = prog.device
        self.art = prog.artifact
        self.T = prog.T
        self.x_min = prog.x_min
        self.leak_shift = prog.leak_shift
        self.thr = prog.thresholds
        bundle, self.cache_hit = get_cache().bundle(
            ("reference", *prog.cache_key),
            lambda: {"w_f32": prog.w_int8.to(torch.float32)},
            nbytes=program_nbytes(prog))
        self._w_f32 = bundle["w_f32"]

    def forward(self, images) -> SNNOutput:
        x = as_images(images, self.device)
        times = ttfs.encode_ttfs(x, self.T, self.x_min)         # (B, N_in)
        raster = ttfs.frames_from_times(times, self.T)          # (B, T, N_in)
        currents = spike_currents(raster, self._w_f32)          # (B, T, N_out)
        res = lif_scan(currents.movedim(1, 0), self.thr, self.leak_shift,
                       self.T)
        labels = decode_output(res.first_spike, res.v_final,
                               self.program.decode)
        steps = torch.full_like(labels, self.T)
        return SNNOutput(labels, res.first_spike, res.v_final, steps)

    __call__ = forward
