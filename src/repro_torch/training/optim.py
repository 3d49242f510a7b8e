"""Optimisers as functional updates on tensors — the port of
``repro.training.optim`` (AdamW, Adafactor, SGD with momentum):

    opt = adamw(lr=3e-3, weight_decay=1e-4)
    state = opt.init(params)                       # params: {name: tensor}
    new_params, new_state = opt.update(grads, state, params)

Each follows the JAX package's order of operations exactly: float32 moments
whatever the parameter's dtype, updates cast back to it, and the step count
``state["step"]`` (JAX's int32 count, a Python int here) turned into a
float32 ``t`` where a formula reads it. AdamW computes bias corrections
``1 - b**t`` and ``u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p``, then
``p - lr * u``; ``torch.optim.AdamW`` places eps and the decay differently
(decoupled decay applied to p before the step, eps added to the
bias-corrected root), so its updates round apart from JAX's; it is not
used. Adafactor factors every leaf of rank 2 or more into row and column
second moments and clips each leaf's update to an RMS of ``clip``.

The state keeps JAX's layout: ``{"step", "m", "v"}`` (AdamW), ``{"step",
"f"}`` with ``{"vr", "vc"}`` or ``{"v"}`` per leaf (Adafactor), ``{"step",
"mom"}`` (SGD), each slot a dict keyed like ``params``. A leaf is what JAX
holds: for the LM, a whole stacked leaf (``models.convert.leaf_groups``),
since Adafactor's factoring and clip reduce over all its periods together.
``init_leaf`` and ``update_leaf`` are the per-leaf halves of ``init`` and
``update``; ``update_leaf`` writes the parameter and the state in place,
with JAX's arithmetic (``m.mul_(b1).add_((1 - b1) * g)`` rounds as
``b1 * m + (1 - b1) * g``), for callers that update the model where it
lies (``training.lm_step``), a whole leaf at a time or, where the
optimiser is ``elementwise``, a slice at a time. ``update`` is the
functional form: it updates copies.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], tuple[dict, dict]]
    name: str
    #: leaf tensor -> {slot: its state}
    init_leaf: Callable[[torch.Tensor], dict]
    #: (grad, {slot: state}, param, step): the param and the state updated
    #: in place
    update_leaf: Callable[[torch.Tensor, dict, torch.Tensor, int], None]
    #: whether each element's update reads only that element, so a leaf may
    #: be updated a slice at a time (AdamW, SGD; not Adafactor)
    elementwise: bool


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _optimizer(name: str, init_leaf, update_leaf,
               elementwise: bool) -> Optimizer:
    def init(params: dict) -> dict:
        state: dict[str, Any] = {"step": 0}
        for k, p in params.items():
            for slot, s in init_leaf(p).items():
                state.setdefault(slot, {})[k] = s
        return state

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        step = state["step"] + 1
        slots = [s for s in state if s != "step"]
        new_p = {k: p.clone() for k, p in params.items()}
        new_state = {"step": step, **{s: _clone(state[s]) for s in slots}}
        for k, p in new_p.items():
            update_leaf(grads[k], {s: new_state[s][k] for s in slots}, p,
                        step)
        return new_p, new_state

    return Optimizer(init, update, name, init_leaf,
                     torch.no_grad()(update_leaf), elementwise)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init_leaf(p):
        return {"m": _zeros(p.shape, p), "v": _zeros(p.shape, p)}

    def update_leaf(g, s, p, step):
        t = _f32(float(step), p)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        g = g.to(torch.float32)
        m = s["m"].mul_(b1).add_((1 - b1) * g)
        v = s["v"].mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * u)   # cast to p's dtype

    return _optimizer("adamw", init_leaf, update_leaf, elementwise=True)


def factored_means(g2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Adafactor's new row and column terms of a leaf's squared gradient:
    its means over the last axis and over the second to last."""
    return torch.mean(g2, dim=-1), torch.mean(g2, dim=-2)


def factored_moment(v: torch.Tensor, beta: torch.Tensor,
                    new: torch.Tensor) -> torch.Tensor:
    """A factored moment ``v`` (``vr`` or ``vc``) updated in place:
    ``beta * v + (1 - beta) * new``, ``new`` the matching mean of
    ``factored_means``."""
    return v.mul_(beta).add_((1 - beta) * new)


def factored_scale(g: torch.Tensor, vr: torch.Tensor,
                   vc: torch.Tensor) -> torch.Tensor:
    """g over the root of the factored second moment, ``vr / mean(vr)``
    (rows) times ``vc`` (columns), in g's shape."""
    rden = torch.mean(vr, dim=-1, keepdim=True)
    return g / (torch.sqrt(vr / rden)[..., None]
                * torch.sqrt(vc)[..., None, :] + 1e-16)


def adafactor(lr: float = 3e-4, eps: float = 1e-30, clip: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments (Shazeer & Stern 2018), no first moment. A
    leaf of rank 2 or more keeps ``vr`` (its shape less the last axis) and
    ``vc`` (less the second to last), so a stacked norm scale (n_periods,
    d) is factored across its periods, as in JAX."""
    def factored(p):
        return p.dim() >= 2

    def init_leaf(p):
        if factored(p):
            return {"f": {"vr": _zeros(p.shape[:-1], p),
                          "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}}
        return {"f": {"v": _zeros(p.shape, p)}}

    def update_leaf(g, s, p, step):
        t = _f32(float(step), p)
        beta = 1.0 - t ** (-decay)
        g = g.to(torch.float32)
        g2 = g * g + eps
        f = s["f"]
        if factored(p):
            rows, cols = factored_means(g2)
            vr = factored_moment(f["vr"], beta, rows)
            vc = factored_moment(f["vc"], beta, cols)
            u = factored_scale(g, vr, vc)
        else:
            v = f["v"].mul_(beta).add_((1 - beta) * g2)
            u = g / (torch.sqrt(v) + 1e-16)
        # update clipping (RMS <= clip), over the whole leaf
        rms = torch.sqrt(torch.mean(u * u) + 1e-16)
        u = u / torch.clamp_min(rms / clip, 1.0)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * u)   # cast to p's dtype

    return _optimizer("adafactor", init_leaf, update_leaf, elementwise=False)


def sgd(lr: float = 0.1, momentum: float = 0.9) -> Optimizer:
    def init_leaf(p):
        return {"mom": _zeros(p.shape, p)}

    def update_leaf(g, s, p, step):
        m = s["mom"].mul_(momentum).add_(g.to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * m)

    return _optimizer("sgd", init_leaf, update_leaf, elementwise=True)


def get(name: str, lr: float) -> Optimizer:
    """The optimiser a config names (``cfg.optimizer``) at learning rate
    ``lr``, its other settings JAX's defaults."""
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](lr=lr)
