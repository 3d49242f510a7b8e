#!/usr/bin/env python3
"""Where the staged SNN kernels' wrappers spend their host time, on one card.

    python3 scripts/torch_wrapper_host.py [--calls 1000] [--reps 7]

At the SNN serving shape of chip_smoke.py's phase 7 (B 64, T 32, N_pad
256; the decode over n = 150 lanes in 10 groups of 15; random int32 inputs
from a seed, the currents handed over as the staged path's movedim view),
it times on the host clock each step that ``lif_fused`` and ``ttfs_decode``
take for a launch, and each whole wrapper call. A step runs ``--calls``
times in a loop, the card is synchronised after the loop (outside the
clock), the steps take turns loop by loop, and the median over ``--reps``
rounds is printed in microseconds a call. The steps include the lookups
the wrappers made before ``kernels/common.py`` took the short way
(``torch.cuda.device`` around every launch,
``torch.cuda.current_stream(...).cuda_stream``, ``torch.empty`` for the
outputs), so one run shows both. The card's name and power limit are
printed before the last line, one JSON object of every step's median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, N_PAD, N_GROUPS, PER_GROUP = 64, 32, 256, 10, 15


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=7)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.lif_dynamics import LIFResult
    from repro_torch.kernels import common
    from repro_torch.kernels.lif import ops as lif
    from repro_torch.kernels.ttfs_decode import ops as dec

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(dev).manual_seed(0)
    cur = torch.randint(-300, 400, (B, T, N_PAD), generator=g, device=dev,
                        dtype=torch.int32)
    view = cur.movedim(1, 0)
    thr = torch.randint(200, 2000, (N_PAD,), generator=g, device=dev,
                        dtype=torch.int32)
    state = lif.lif_fused(view, thr, 3)
    n = N_GROUPS * PER_GROUP
    first, v = state.first_spike[:, :n], state.v_final[:, :n]
    dkw = dict(n_groups=N_GROUPS, per_group=PER_GROUP, sentinel=T,
               fallback="membrane")
    lib_l, lib_d = lif._lib(), dec._lib()
    s_t, s_b, s_n = view.stride()
    raw = torch.cuda.current_stream(dev).cuda_stream
    lif_args = (view.data_ptr(), s_t, s_b, s_n, thr.data_ptr(),
                first.data_ptr(), v.data_ptr(), B, T, N_PAD, 3, raw)
    labels = torch.empty((B,), dtype=torch.int32, device=dev)
    dec_args = (first.data_ptr(), v.data_ptr(), first.stride(0),
                v.stride(0), labels.data_ptr(), B, N_GROUPS,
                PER_GROUP, T, 1, 0, raw)      # membrane, a warp a row

    def device_switch():
        with torch.cuda.device(view.device):
            pass

    def no_switch():
        with common.on_device(view):
            pass

    steps = {
        "empty loop": lambda: None,
        "check_tensors (2 tensors)": lambda: common.check_tensors(
            view.device, currents=(view, torch.int32),
            thresholds=(thr, torch.int32)),
        "is_cuda + is_contiguous": lambda: view.is_cuda and
        thr.is_contiguous(),
        "torch.empty (B, n) twice": lambda: (
            torch.empty((B, N_PAD), dtype=torch.int32, device=dev),
            torch.empty((B, N_PAD), dtype=torch.int32, device=dev)),
        "torch.empty (2, B, n) + unbind": lambda: torch.empty(
            (2, B, N_PAD), dtype=torch.int32, device=dev).unbind(0),
        "torch.empty (2, B, n)": lambda: torch.empty(
            (2, B, N_PAD), dtype=torch.int32, device=dev),
        "t.new_empty (2, B, n)": lambda: view.new_empty((2, B, N_PAD)),
        "torch.empty (B,) labels": lambda: torch.empty(
            (B,), dtype=torch.int32, device=dev),
        "t.new_empty (B,) labels": lambda: view.new_empty((B,)),
        "t.get_device()": view.get_device,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "stride() + 4 data_ptr()": lambda: (
            view.stride(), view.data_ptr(), thr.data_ptr(),
            first.data_ptr(), v.data_ptr()),
        "torch.cuda.device(t.device) enter/exit": device_switch,
        "on_device(t) enter/exit": no_switch,
        "torch.cuda.current_stream(d).cuda_stream":
            lambda: torch.cuda.current_stream(view.device).cuda_stream,
        "stream(t)": lambda: common.stream(view),
        "_lib() lookup": lif._lib,
        "ctypes lif_fused launch": lambda: lib_l.lif_fused(*lif_args),
        "ctypes ttfs_decode launch": lambda: lib_d.ttfs_decode(*dec_args),
        "LIFResult(first, v)": lambda: LIFResult(first_spike=first,
                                                  v_final=v),
        "whole lif_fused call": lambda: lif.lif_fused(view, thr, 3),
        "whole ttfs_decode call": lambda: dec.ttfs_decode(first, v, **dkw),
    }
    card = card_line()
    for fn in steps.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in steps}
    for _ in range(opts.reps):            # the steps in turns, rep by rep
        for name, fn in steps.items():
            t0 = time.perf_counter()
            for _ in range(opts.calls):
                fn()
            samples[name].append(1e6 * (time.perf_counter() - t0)
                                 / opts.calls)
            torch.cuda.synchronize()
    out = {}
    for name, xs in samples.items():
        out[name] = statistics.median(xs)
        print(f"[host] {name:44s} {out[name]:8.3f} us a call (median of "
              f"{opts.reps} x {opts.calls}; spread {max(xs) - min(xs):.3f})"
              f" — card: {card}")
    print(card)
    print(json.dumps({"card": card, "us_per_call": out}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
