"""Serving launcher of the port, LM role: --arch <id>, a batched request
stream through ``ServeEngine`` on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
        --requests 16 --max-new 12 --device cpu

Parameters are drawn in float32 from a seeded generator, as the JAX
launcher draws them (``repro.launch.serve``); the prompts are JAX's, from
``numpy.random.RandomState(0)``. The SNN roles (``--snn-artifact`` with a
program transport) wait for ROADMAP §1 item 4.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced as make_reduced
from repro_torch.core.lowering import resolve_device
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--snn-artifact",
                    help="serve an exported SNN artifact (not ported yet)")
    args = ap.parse_args(argv)
    if args.snn_artifact:
        raise NotImplementedError(
            "the SNN roles of the launcher (--snn-artifact, program "
            "transport) wait for ROADMAP §1 item 4")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    lm = LM(cfg, dtype=torch.float32, device=dev)
    lm.init_params(torch.Generator(dev).manual_seed(0))
    engine = ServeEngine(lm, max_batch=args.max_batch, s_max=256,
                         device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, rng.randint(4, 16)).astype(np.int32)
               for _ in range(args.requests)]
    outs = engine.generate(prompts, max_new=args.max_new)
    st = engine.stats()
    print(f"served {len(outs)} requests on {dev}; "
          f"accelerator {st['accelerator_s']:.2f}s / "
          f"system {st['system_s']:.2f}s, {st['tokens_out']} tokens out")
    return st


if __name__ == "__main__":
    main()
