"""Batched LM serving demo on the PyTorch/CUDA port (the counterpart of
``serve_lm.py``), with the paper's scope-aware measurement discipline
applied to serving: accelerator scope (the decode step) vs system scope
(queueing, batching, host transfers) reported separately.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch yi-6b \\
        --requests 12
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The reduced config's model is drawn in float32 from seed 0 (JAX's example
draws from ``PRNGKey(0)``: the numbers differ). Without a card pass
``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.lowering import resolve_device
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    lm = LM(cfg, dtype=torch.float32, device=dev)
    lm.init_params(torch.Generator(dev).manual_seed(0))
    engine = ServeEngine(lm, max_batch=args.max_batch, s_max=256, device=dev)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, rng.randint(8, 24)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new=args.max_new)
    wall = time.perf_counter() - t0

    for i, o in enumerate(outs[:4]):
        print(f"req{i}: prompt[{len(prompts[i])}] -> {o}")
    st = engine.stats()
    total_tok = sum(len(o) for o in outs)
    print(f"\n{args.requests} requests, {total_tok} tokens in {wall:.2f}s "
          f"({total_tok / wall:.1f} tok/s, batch={args.max_batch})")
    print(f"accelerator-scope: {st['accelerator_s']:.2f}s   "
          f"system-scope: {st['system_s']:.2f}s   "
          f"host overhead: {st['host_overhead_s']:.2f}s")
    print("(same artifact->runtime discipline as the SNN path: the engine "
          "consumes the model's parameters unchanged)")
    return {"prompts": prompts, "outputs": outs, "stats": st,
            "tokens": total_tok, "wall_s": wall}


if __name__ == "__main__":
    main()
