"""AdamW as a functional update on tensors — the port of
``repro.training.optim.adamw``:

    opt = adamw(lr=3e-3, weight_decay=1e-4)
    state = opt.init(params)                       # params: {name: tensor}
    new_params, new_state = opt.update(grads, state, params)

It follows the JAX package's order of operations exactly: float32 moments,
bias corrections ``1 - b**t`` with t a float32 step count,
``u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p`` and ``p - lr * u``.
``torch.optim.AdamW`` places eps and the decay differently (decoupled decay
applied to p before the step, eps added to the bias-corrected root), so its
updates round apart from JAX's; it is not used. Adafactor and SGD are not
ported yet (ROADMAP §1 item 10).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    name: str


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params: dict[str, torch.Tensor]) -> dict:
        return {"step": 0,
                "m": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        step = state["step"] + 1
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            t = torch.tensor(float(step), dtype=torch.float32,
                             device=p.device)
            bc1 = 1 - b1 ** t
            bc2 = 1 - b2 ** t
            g = grads[k].to(torch.float32)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32) - lr * u).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"step": step, "m": new_m, "v": new_v}

    return Optimizer(init, update, "adamw")
