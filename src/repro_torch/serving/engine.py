"""Batched LM serving engine: prefill and greedy decode over a list of
prompts.

The port of ``repro.serving.engine.ServeEngine``, with its semantics:
prompts are served in chunks of ``max_batch``; each chunk is left-padded
with token 0 (no attention mask over the pads) and prefilled token by token
through ``decode_step``; decoding is greedy (argmax, the first index on
ties) and a row stops after emitting ``eos``. Two scopes are reported apart
by ``stats()``:

  * accelerator — the decode steps, up to ``torch.cuda.synchronize()`` on
    the card (on the CPU the step's own time);
  * system — everything ``generate`` spends, padding, host transfers and
    sampling included; ``host_overhead_s`` is the difference.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.lowering import resolve_device
from repro_torch.models.model import LM


class ServeEngine:
    def __init__(self, lm: LM, *, max_batch: int = 8, s_max: int = 256,
                 eos: int | None = None, device: str | torch.device = "cuda"):
        """Serves ``lm`` on ``device``, which must be the model's, in its
        parameters' dtype."""
        dev = resolve_device(device)
        if lm.device != dev:
            raise ValueError(f"the model lies on {lm.device}, not on {dev}")
        self.lm = lm
        self.max_batch, self.s_max, self.eos = max_batch, s_max, eos
        self.accel_s = 0.0
        self.system_s = 0.0
        self.tokens_out = 0

    def _decode(self, cache, tokens):
        t0 = time.perf_counter()
        logits, cache = self.lm.decode_step(cache, tokens)
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        self.accel_s += time.perf_counter() - t0
        return logits, cache

    @staticmethod
    def _greedy(logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32).cpu().numpy()

    def generate(self, prompts: Sequence[np.ndarray], max_new: int = 16
                 ) -> list[list[int]]:
        t_sys0 = time.perf_counter()
        results: list[list[int]] = []
        for i in range(0, len(prompts), self.max_batch):
            results.extend(self._generate_batch(
                prompts[i:i + self.max_batch], max_new))
        self.system_s += time.perf_counter() - t_sys0
        return results

    def _generate_batch(self, prompts, max_new: int) -> list[list[int]]:
        B = len(prompts)
        S = max(len(p) for p in prompts)
        toks = np.zeros((B, S), np.int32)
        for b, p in enumerate(prompts):
            toks[b, S - len(p):] = p                 # left-pad (greedy-safe)
        cache = self.lm.init_cache(B, self.s_max)
        x = torch.from_numpy(toks).to(self.lm.device)
        logits = None
        for t in range(S):
            logits, cache = self._decode(cache, x[:, t:t + 1])
        outs = [[] for _ in range(B)]
        cur = self._greedy(logits)
        done = np.zeros(B, bool)
        for _ in range(max_new):
            for b in range(B):
                if not done[b]:
                    outs[b].append(int(cur[b]))
                    if self.eos is not None and cur[b] == self.eos:
                        done[b] = True
            if done.all():
                break
            nxt = torch.from_numpy(cur[:, None]).to(self.lm.device)
            logits, cache = self._decode(cache, nxt)
            cur = self._greedy(logits)
            self.tokens_out += int(np.sum(~done))
        return outs

    def stats(self) -> dict:
        return {
            "accelerator_s": self.accel_s,
            "system_s": self.system_s,
            "host_overhead_s": max(0.0, self.system_s - self.accel_s),
            "tokens_out": self.tokens_out,
        }
