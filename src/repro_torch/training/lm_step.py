"""LM step factories of the port: training, serving and prefill.

The port of ``repro.training.lm_step``. ``make_train_step`` is JAX's train
step: gradient accumulation over micro-batches (float32 sums, in order,
then divided by ``grad_accum``), optional int8 compression with error
feedback before the optimiser, and the gradient norm of what the
optimiser receives. It works on JAX's leaves (``models.convert.
leaf_groups``), one at a time, and updates each where it lies (the
model's stacked leaves hold its per-period parameters): an elementwise
optimiser (AdamW, SGD) a period at a time on slices of the leaf and of
its state; Adafactor, whose factoring and clip read the whole leaf,
compression, whose scale does, and a leaf whose periods are copies rather
than views of it (``LeafGroup.views``: a ``DTensor`` stacked over a period
dim sharded over the data axes), on the period gradients stacked into the
leaf's shape. The optimiser state and the residual keep
JAX's tree layout, keyed by the leaves' ``"/"``-joined paths, so a
checkpoint of ``{"params": lm_to_jax(lm), "opt": opt_state}`` is JAX's
(``training.checkpoint``). Remat follows ``cfg.remat`` inside the model.
The serve and prefill steps pass through to ``LM.decode_step`` and a
forward that builds no graph, as JAX's ``make_serve_step`` and
``make_prefill_step``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.convert import leaf_groups
from repro_torch.models.model import LM
from repro_torch.telemetry import trace
from repro_torch.training import compress as C
from repro_torch.training import optim as O


def make_train_step(lm: LM, optimizer: O.Optimizer, *, grad_accum: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.

    Unlike JAX's functional ``train_step(params, opt_state, batch)``, the
    LM's parameters are updated in place and so is ``opt_state`` (the same
    dict comes back, its moments updated in place, its step and residual
    replaced): a second copy of the
    parameters and of the optimiser state would not fit the card at full
    width. ``batch`` holds tensors on the model's device: ``tokens``,
    ``labels`` (B, S) and optionally ``enc_frames`` / ``patch_embeds``.
    ``metrics``: ``loss`` and ``grad_norm`` (float32 scalars), and ``ce``,
    ``aux``, ``tokens`` (``ce`` alone when accumulating, as in JAX).
    ``opt_state`` is ``{"opt", "residual"}`` when compressing."""
    groups = leaf_groups(lm)
    params = [t for g in groups for t in g.tensors]
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be at least 1")

    def backward(batch):
        loss, metrics = lm.loss(batch)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def grads_of(batch):
        if grad_accum == 1:
            loss, metrics = backward(batch)
            return loss, metrics, [_grad(t) for t in params]
        B = batch["tokens"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} is not a multiple of grad_accum "
                             f"{grad_accum}")
        mb = B // grad_accum
        acc, loss_sum = None, None
        for i in range(grad_accum):
            loss, _ = backward({k: v[i * mb:(i + 1) * mb]
                                for k, v in batch.items()})
            g = [_grad(t).to(torch.float32) for t in params]
            for t in params:
                t.grad = None
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = [a / grad_accum for a in acc]
        loss = loss_sum / grad_accum
        return loss, {"ce": loss}, grads

    def train_step(opt_state: dict, batch: dict) -> tuple[dict, dict]:
        for t in params:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics, flat = grads_of(batch)
        finally:
            for t in params:
                t.requires_grad_(False)
                t.grad = None
        inner = opt_state["opt"] if compress_grads else opt_state
        step = inner["step"] + 1
        slots = [s for s in inner if s != "step"]
        sq = None                       # the gradients' sum of squares
        at = 0
        with torch.no_grad():
            for grp in groups:
                n = len(grp.tensors)
                gs, flat[at:at + n] = flat[at:at + n], [None] * n
                at += n
                state = {s: inner[s][grp.path] for s in slots}
                if optimizer.elementwise and not compress_grads and \
                        grp.views:
                    # a period at a time, on slices of the leaf and state
                    for i, (g, p) in enumerate(zip(gs, grp.tensors)):
                        sq = _add_sq(sq, g)
                        optimizer.update_leaf(
                            g, {s: v[i] if grp.stacked else v
                                for s, v in state.items()}, p, step)
                    continue
                g = grp.stack(gs)
                del gs
                if compress_grads:
                    q, scale, opt_state["residual"][grp.path] = \
                        C.compress_leaf(g, opt_state["residual"][grp.path])
                    g = C.decompress_leaf(q, scale)
                sq = _add_sq(sq, g)
                optimizer.update_leaf(g, state, grp.leaf, step)
        inner["step"] = step
        return opt_state, {"loss": loss.to(torch.float32),
                           "grad_norm": _grad_norm(sq), **metrics}

    return train_step


def _add_sq(sq: torch.Tensor | None, g: torch.Tensor) -> torch.Tensor:
    """``sq`` (None before the first) plus the float32 sum of ``g``'s
    squares."""
    s = torch.sum(torch.square(g.to(torch.float32)))
    return s if sq is None else sq + s


def _grad_norm(sq: torch.Tensor) -> torch.Tensor:
    """The gradient norm from the gradients' sum of squares."""
    return torch.sqrt(sq)


def _grad(t: torch.Tensor) -> torch.Tensor:
    """``t``'s gradient; zero where the loss does not reach it, as JAX's."""
    return torch.zeros_like(t) if t.grad is None else t.grad


def make_opt_state(lm: LM, optimizer: O.Optimizer,
                   compress_grads: bool = False) -> dict:
    """The optimiser's state over ``lm``'s JAX leaves, and the zero
    residual when compressing."""
    leaves = {g.path: g.leaf for g in leaf_groups(lm)}
    if compress_grads:
        return {"opt": optimizer.init(leaves),
                "residual": C.init_residual(leaves)}
    return optimizer.init(leaves)


def make_serve_step(lm: LM) -> Callable:
    """serve_step(cache, tokens (B, 1)) -> (logits, cache'): one decode step
    against the KV cache."""
    def serve_step(cache: dict, tokens: torch.Tensor):
        return lm.decode_step(cache, tokens)
    return serve_step


def make_prefill_step(lm: LM) -> Callable:
    """prefill_step(tokens (B, S), **frontend) -> logits (B, S, V): the full
    forward, no labels and no graph; ``frontend`` is the forward's
    ``patch_embeds`` or ``enc_frames``. On the card each attention sublayer
    is one launch of the flash kernel (an encoder-decoder's decoder
    sublayers two, self- and cross-attention, and each encoder layer one);
    MoE and mamba sublayers launch none. Each call is one ``prefill`` device
    span (``telemetry.trace``), the root of the forward's spans."""
    @torch.no_grad()
    def prefill_step(tokens: torch.Tensor, **frontend) -> torch.Tensor:
        with trace.device_span("prefill"):
            logits, _ = lm.forward(tokens, **frontend)
        return logits
    return prefill_step
