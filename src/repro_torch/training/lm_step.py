"""LM step factories of the port: serving and prefill only.

The port of ``repro.training.lm_step.make_serve_step`` and
``make_prefill_step``. Training (``make_train_step``), the optimisers and
gradient compression wait for ROADMAP §1 item 10, with the backward kernels.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import LM


def make_serve_step(lm: LM) -> Callable:
    """serve_step(cache, tokens (B, 1)) -> (logits, cache'): one decode step
    against the KV cache."""
    def serve_step(cache: dict, tokens: torch.Tensor):
        return lm.decode_step(cache, tokens)
    return serve_step


def make_prefill_step(lm: LM) -> Callable:
    """prefill_step(tokens (B, S)) -> logits (B, S, V): the full forward, no
    labels. On the card each attention sublayer is one launch of the flash
    kernel; MoE and mamba sublayers launch none."""
    def prefill_step(tokens: torch.Tensor) -> torch.Tensor:
        logits, _ = lm.forward(tokens)
        return logits
    return prefill_step
