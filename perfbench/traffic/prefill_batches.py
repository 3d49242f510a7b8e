"""Closed-loop prefill: one caller hands ``make_prefill_step(lm)`` a batch of
``batch`` rows of ``seq`` token ids, waits for the logits, and sends the
next. Call i's ids are uniform over the vocabulary, drawn on the device from
the seed and i, so every call is new and every seed does the same work.

Traffic file keys: ``driver`` ("prefill_batches"), ``batch``, ``seq``,
``warm_calls`` (set-up, at the window's shape), ``check_calls`` calls drawn
from the seed among the first ``check_within`` (their whole logits, and
the routing of each expert layer, kept and compared), ``trace_calls``
(with ``--trace 1``, calls traced after the window has closed, so that the
profiler's cost stays out of it).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench import compare, counts
from perfbench.trace import ranged
from perfbench.weights import leaf_seed


def tokens(cell, i: int) -> torch.Tensor:
    t = cell.traffic
    g = torch.Generator(device=cell.device)
    g.manual_seed(leaf_seed(cell.seed, f"prefill:{i}"))
    return torch.randint(0, cell.config["vocab_size"], (t["batch"], t["seq"]),
                         generator=g, device=cell.device)


class RouteLog:
    """``models/moe.py::route`` wrapped from this file: while ``rec`` is a
    list, the routing of each expert layer, (experts (B, S, k), kept (B, S,
    k)), is appended to it; otherwise a pass-through."""

    def __init__(self, route):
        self.route, self.rec = route, None

    def __call__(self, *args, **kw):
        r = self.route(*args, **kw)
        if self.rec is not None:
            self.rec.append((r.top_i, r.keep.reshape(r.top_i.shape)))
        return r


def setup(cell, lm) -> dict:
    from repro_torch.models import moe
    from repro_torch.training.lm_step import make_prefill_step
    if cell.trace:
        moe.moe_ffn = ranged("moe_ffn", moe.moe_ffn)
    if not isinstance(moe.route, RouteLog):
        moe.route = RouteLog(moe.route)
    step = make_prefill_step(lm)
    for i in range(cell.traffic["warm_calls"]):
        step(tokens(cell, -1 - i))
    cell.sync()
    return {"step": step, "log": moe.route, "moe": bool(lm.cfg.n_experts)}


def window(cell, state, seconds: float, tracer) -> dict:
    t = cell.traffic
    step, log = state["step"], state["log"]
    rng = random.Random(leaf_seed(cell.seed, "check"))
    chosen = set(rng.sample(range(t["check_within"]), t["check_calls"]))
    kept, times = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        log.rec = [] if i in chosen else None
        ts = time.perf_counter()
        out = step(tokens(cell, i))
        cell.sync()
        te = time.perf_counter()
        times.append(te - ts)
        if i in chosen:
            kept.append((i, out, log.rec if state["moe"] else None))
        log.rec = None
        del out
        i += 1
        if te - t0 >= seconds and i > max(chosen):
            break
    span = te - t0
    if cell.trace:
        tracer.start()
        for j in range(t["trace_calls"]):
            step(tokens(cell, i + j))
        tracer.stop()
    n_tok = t["batch"] * t["seq"] * len(times)
    return {
        "attempted": len(times), "failed": 0, "kept": kept,
        "end_to_end": {
            "prefill_tokens_per_s": n_tok / span,
            "prefill_ms_p90": float(np.percentile(np.array(times) * 1e3, 90)),
        },
        "counters": {
            "calls": len(times), "window_s": span,
            "flops": counts.prefill_flops(cell.config, t["batch"], t["seq"])
            * len(times),
            "traced_calls": t["trace_calls"],
        },
    }


def check(cell, win: dict, control: bool = False) -> dict:
    calls = [(tokens(cell, i), out, routing)
             for i, out, routing in win["kept"]]
    return compare.prefill_numbers(cell.config, calls, cell.seed, cell.device,
                                   control=control, dtype=cell.dtype)
