#!/usr/bin/env python3
"""Host time of kernel 8's wrappers, this tree's against another
``ops.py``'s, in one process on the card.

    python3 scripts/flash_attention_host_ab.py --parent PATH/ops.py \
        [--turns 8]

``PATH/ops.py`` is another version of
``src/repro_torch/kernels/flash_attention/ops.py`` (for example the parent
commit's, ``git show HEAD~1:src/repro_torch/kernels/flash_attention/
ops.py``), loaded beside this tree's as a module of its own, and this
tree's file is loaded a second time as a third module, the control (an A/A
pair: what two loads of one file read apart); all three call the same
built kernels. For 8a (bf16, the tensor-core kernel), 8b (float32, split
TF32) at (B 1, Hq 32, Hkv 8, S 4096, D 128, causal) and the backward at
Yi-6B's training shape (B 4, Hq 32, Hkv 4, S 2048, D 128, float32), it
queues ``BACK`` calls of each wrapper behind a spin kernel, so no call
waits for the card, and reads the host clock around the queueing: host ms
per call, median of ``SAMPLES``, once a turn for each module, the order
reversed every other turn. It prints one line a kernel (each module's
median over the turns, its least and its most) and the card's name and
power limit.
"""

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BACK, SAMPLES, SPIN = 20, 30, 20_000_000


def main() -> int:
    import torch

    from repro_torch.kernels.flash_attention import ops
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--turns", type=int, default=8)
    args = ap.parse_args()

    def load(name, path):
        spec = importlib.util.spec_from_file_location(
            f"repro_torch.kernels.flash_attention.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    mods = {"parent": load("ops_parent", args.parent), "tree": ops,
            "tree-copy": load("ops_copy", ops.__file__)}
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def qkv(B, Hq, Hkv, S, dtype):
        return [torch.randn((B, h, S, 128), generator=g, device=dev,
                            dtype=torch.float32).to(dtype)
                for h in (Hq, Hkv, Hkv)]

    q8a = qkv(1, 32, 8, 4096, torch.bfloat16)
    q8b = qkv(1, 32, 8, 4096, torch.float32)
    qb = qkv(4, 32, 4, 2048, torch.float32)
    out, lse = ops.flash_attention(*qb, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device=dev)
    cases = {
        "flash_attention_sm90 (8a)": lambda m: m.flash_attention(*q8a),
        "flash_attention (8b)": lambda m: m.flash_attention(*q8b),
        "flash_attention_bwd (8-bwd)": lambda m: m.flash_attention_bwd(
            *qb, out, lse, dout)}

    def host_ms(fn):
        samples = []
        for _ in range(SAMPLES):
            torch.cuda._sleep(SPIN)
            t0 = time.perf_counter()
            for _ in range(BACK):
                fn()
            samples.append(1e3 * (time.perf_counter() - t0) / BACK)
            torch.cuda.synchronize()
        return statistics.median(samples)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    order = list(mods)
    for name, call in cases.items():
        for m in mods.values():
            for _ in range(5):
                call(m)
        torch.cuda.synchronize()
        read = {who: [] for who in mods}
        for turn in range(args.turns):
            for who in (order if turn % 2 == 0 else order[::-1]):
                read[who].append(host_ms(lambda: call(mods[who])))
        cols = ", ".join(
            f"{who} {statistics.median(r):.4f} [{min(r):.4f}–{max(r):.4f}]"
            for who, r in read.items())
        print(f"[host-ab] {name}: wrapper host ms per call, median over "
              f"{args.turns} turns [least–most]: {cols} (each turn's "
              f"reading the median of {SAMPLES} x {BACK} calls) — card: "
              f"{card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
