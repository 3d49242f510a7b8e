"""LM step factories of the port: serving and prefill only.

The port of ``repro.training.lm_step.make_serve_step`` and
``make_prefill_step``; the prefill step passes the frontend stubs
(``patch_embeds``, ``enc_frames``) on to the forward, as JAX's does.
Training (``make_train_step``), the optimisers and gradient compression
wait for ROADMAP §1 item 10, with the backward kernels.
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
    """prefill_step(tokens (B, S), **frontend) -> logits (B, S, V): the full
    forward, no labels; ``frontend`` is the forward's ``patch_embeds`` or
    ``enc_frames``. On the card each attention sublayer is one launch of
    the flash kernel (an encoder-decoder's decoder sublayers two, self- and
    cross-attention, and each encoder layer one); MoE and mamba sublayers
    launch none."""
    def prefill_step(tokens: torch.Tensor, **frontend) -> torch.Tensor:
        logits, _ = lm.forward(tokens, **frontend)
        return logits
    return prefill_step
