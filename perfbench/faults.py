"""Faults planted in the program under a run: what a later change could
break in the timed path, each of which the comparison must read as not
correct. ``control.py --fault`` reads them on the card at a cell's own
size (the readings a limit's upper end is set from); the tests plant them
under a whole tiny run on the CPU.

* ``answer``: every call's logits a position late.
* ``half_batch``: the second half of each call's rows replaced by the
  first half's answers.
* ``route_third``: on a tenth of the tokens, drawn anew in each expert
  layer, the router's last choice replaced by its next best.
* ``router_bf16``, ``router_fp8``: the router's logits computed from
  bfloat16, or float8 e4m3 (scaled per row and column), operands.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("answer", "half_batch", "route_third", "router_bf16", "router_fp8")
ROUTE_SHARE = 0.1


@contextlib.contextmanager
def plant(name: str, seed: int = 0):
    """The program's module attribute that ``name`` breaks, replaced while
    the context is open."""
    if name in ("answer", "half_batch"):
        from repro_torch.training import lm_step as mod
        attr = "make_prefill_step"
        new = _broken_step(mod.make_prefill_step, name)
    elif name == "route_third":
        from repro_torch.models import moe as mod
        attr = "topk"
        new = _third(mod.topk, seed)
    elif name in ("router_bf16", "router_fp8"):
        from repro_torch.models import moe as mod
        attr = "_probs"
        new = _low_router(name)
    else:
        raise ValueError(f"no fault {name!r}; faults: {', '.join(FAULTS)}")
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    try:
        yield
    finally:
        setattr(mod, attr, old)


def _broken_step(make, name):
    def broken(lm):
        step = make(lm)

        def call(tokens):
            out = step(tokens)
            if name == "answer":
                return out.roll(1, dims=1)
            h = out.shape[0] // 2
            out[h:] = out[:out.shape[0] - h]
            return out
        return call
    return broken


def _third(topk, seed: int):
    gens = {}

    def broken(probs, k):
        vals, idx = topk(probs, k + 1)
        dev = probs.device
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        hit = torch.rand(idx.shape[:-1], generator=gens[dev],
                         device=dev) < ROUTE_SHARE
        v, i = vals[..., :k].clone(), idx[..., :k].clone()
        v[..., -1] = torch.where(hit, vals[..., k], vals[..., k - 1])
        i[..., -1] = torch.where(hit, idx[..., k], idx[..., k - 1])
        return v, i
    return broken


def _low_router(name: str):
    def probs(x, router, psum=None):
        a, w = x.float(), router.float()
        if name == "router_bf16":
            logits = (a.bfloat16() @ w.bfloat16()).float()
        else:
            from perfbench.reference.decoder import fp8
            logits = fp8(a, w)
        return torch.softmax(logits if psum is None else psum(logits),
                             dim=-1)
    return probs
