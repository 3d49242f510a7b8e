#!/usr/bin/env python3
"""Where the split-TF32 attention kernel's time goes, on one card.

    python3 scripts/flash_attention_designs.py

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it is and three
variants made from its text (into ``build/designs/``, git-ignored), and
times each alone at Qwen3-8B's head shape (B 1, Hq 32, Hkv 8, S 4096,
D 128, causal, float32; 5 calls between CUDA events, median of 7):

  * ``kernel``: the source as it is;
  * ``register loads``: k and v read by element loads into registers, a job
    at a time, as the kernel reads layouts cp.async does not take (a design
    of its own: right, and timed against the raw ring);
  * ``no copies``: the raw ring is never filled nor waited for, the
    producer splits whatever it holds (wrong by design: the producer's split
    and the consumer without the copies);
  * ``consumer alone``: no copies and no split, the producer only passes
    the slots on (wrong by design: the consumer's products and softmax).

Prints one line a variant (ms, and max |err| against the plain version for
the two that are right), the card's name and power limit, and one JSON
object last.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "designs")
NO_COPIES = [
    ("        cp_async<QUAD>(", "        if (0) cp_async<QUAD>("),
    ("        cp_async_wait<S::RAWN - 1>();", "")]
#: variant -> (substitutions in the source, whether its output is right)
VARIANTS = {
    "kernel": ([], True),
    "register loads": ([("  p.kv_vec = ", "  p.kv_vec = 0 && ")], True),
    "no copies": (NO_COPIES, False),
    "consumer alone": (NO_COPIES + [
        ("        x.load_own(", "        if (0) x.load_own("),
        ("      x.put(smem + S::RING", "      if (0) x.put(smem + S::RING")],
        False),
}
SHAPE = (1, 32, 8, 4096, 128)       # B, Hq, Hkv, S, D


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ref

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: needs a card")
    os.makedirs(OUT, exist_ok=True)
    text = open(SOURCE).read()
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old!r}")
            src = src.replace(old, new)
        stem = os.path.join(OUT, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[name] = (stem + ".so", subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].flash_attention.argtypes = ([P] + [L] * 4) * 4 + \
            [I] * 11 + [P]
        libs[name].flash_attention.restype = I

    dev = torch.device("cuda", torch.cuda.current_device())
    B, Hq, Hkv, S, D = SHAPE
    g = torch.Generator(dev).manual_seed(S)
    q, k, v = (torch.randn(B, h, S, D, generator=g, device=dev)
               for h in (Hq, Hkv, Hkv))
    out = torch.empty_like(q)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = ref.flash_attention_ref(q, k, v)

    def call(lib):
        code = lib.flash_attention(
            q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
            v.data_ptr(), *v.stride(), out.data_ptr(), *out.stride(),
            B, Hq, Hkv, S, S, D, 1, 0, 0, S, 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise SystemExit(f"launch failed with CUDA error {code}")

    results = {}
    for name, lib in libs.items():
        for _ in range(2):
            call(lib)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        samples = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                call(lib)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 5)
        right = VARIANTS[name][1]
        results[name] = {"ms": statistics.median(samples),
                         "max_abs_err": err if right else None}
        print(f"[designs] {name}: {statistics.median(samples):.4f} ms "
              f"(B {B}, Hq {Hq}, Hkv {Hkv}, S {S}, D {D}, causal, float32), "
              + (f"max |err| {err:.3g}" if right else "wrong by design"),
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "designs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
