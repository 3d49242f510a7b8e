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
``SNNReference`` instances over one program on one device share it.

Also hosts the dense baselines of the paper's Table 3: dense grouped-neuron
execution of the SAME exported parameters in FP32 and INT8, as plain
products rather than event-level TTFS runtimes, on the program's device.
The INT8 product multiplies inputs quantised to 0..127 by int8 weights, up
to 127 * 128 a term, so its exact float32 slices are at most
``MAX_EXACT_N_IN_INT8`` inputs wide, not ``MAX_EXACT_N_IN`` (sized for a
{0,1} raster).
"""

from __future__ import annotations

import torch

from repro_torch.core import ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.lif_dynamics import lif_scan
from repro_torch.core.lowering import (MAX_EXACT_N_IN, LoweredProgram,
                                       get_cache, lower, program_nbytes)
from repro_torch.core.types import SNNOutput, decode_output


#: the dense INT8 baseline's exact float32 slice: every partial sum of a
#: slice is an integer of magnitude at most 127 * 128 * rows, exact in
#: float32 while that stays below 2**24 (1,032 inputs)
MAX_EXACT_N_IN_INT8 = (2 ** 24 - 1) // (127 * 128)


def exact_int_product(x: torch.Tensor, w_f32: torch.Tensor,
                      rows: int) -> torch.Tensor:
    """Integer-valued float32 (..., K) x (K, N) -> (..., N) int32, as float32
    products over K slices of at most ``rows`` inputs (each exact by the
    caller's bound) whose int32 partial sums are added. TF32 is turned off
    on the card, so each product runs in full float32."""
    if w_f32.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = None
    for k0 in range(0, w_f32.shape[0], rows):
        part = torch.matmul(x[..., k0:k0 + rows],
                            w_f32[k0:k0 + rows]).to(torch.int32)
        out = part if out is None else out + part
    return out


def spike_currents(raster: torch.Tensor, w_f32: torch.Tensor) -> torch.Tensor:
    """(B, T, N_in) {0,1} raster x (N_in, N) integer-valued float32 weights
    -> (B, T, N) int32 currents, exact (see the module docstring)."""
    return exact_int_product(raster.to(torch.float32), w_f32, MAX_EXACT_N_IN)


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

    # ---------------------------------------------- dense baselines (Table 3)
    def _grouped_mean(self, z: torch.Tensor) -> torch.Tensor:
        p = self.program
        return z.reshape(-1, p.n_groups, p.per_group).mean(dim=-1)

    def dense_logits_fp32(self, images) -> torch.Tensor:
        """Dense grouped-neuron execution, FP32 (the 'GPU FP32' row):
        (B, N_in) images -> (B, n_groups) float32 logits."""
        w = self.program.w_float
        if w.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        return self._grouped_mean(as_images(images, self.device) @ w)

    def dense_logits_int8(self, images) -> torch.Tensor:
        """Dense INT8 execution of the same exported parameters: inputs
        quantised to round(x * 127) in 0..127 (half to even), an exact
        integer product with the int8 weights, the grouped mean in
        float32."""
        x_q = torch.clamp(torch.round(as_images(images, self.device) * 127.0),
                          0, 127)
        z = exact_int_product(x_q, self._w_f32, MAX_EXACT_N_IN_INT8)
        return self._grouped_mean(z.to(torch.float32))

    def dense_labels(self, images, mode: str = "fp32") -> torch.Tensor:
        """Argmax of a dense baseline's logits (``mode`` "fp32" or "int8"),
        ties to the first group, as int32."""
        if mode not in ("fp32", "int8"):
            raise ValueError(f"dense mode {mode!r} (use 'fp32' or 'int8')")
        logits = (self.dense_logits_fp32 if mode == "fp32"
                  else self.dense_logits_int8)(images)
        return torch.argmax(logits, dim=-1).to(torch.int32)
