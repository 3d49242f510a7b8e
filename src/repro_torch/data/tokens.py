"""Synthetic LM token pipeline with deterministic per-host sharding.

The port's copy of ``repro.data.tokens`` (numpy only): the same seed gives
the same batches, token for token, as the JAX package's pipeline.

Determinism is the fault-tolerance primitive: batch ``(step, host)`` is a
pure function of ``(seed, step, host_id, n_hosts)``, so a restarted or
re-joined host regenerates exactly its shard (the straggler/elastic story)
and a restore-from-checkpoint replays the identical stream.

The generator is a mixture of Zipfian unigrams and repeated n-gram motifs so
models have learnable structure (loss decreases) without any external data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 17
    n_hosts: int = 1
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_count: int = 64


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab
        # motif table shared by all hosts (part of the pipeline "schema")
        self.motifs = rng.randint(0, v, (cfg.motif_count, cfg.motif_len))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.probs = (p / p.sum()).astype(np.float64)

    def _host_rng(self, step: int, host: int) -> np.random.RandomState:
        # stable 32-bit mix of (seed, step, host)
        mix = (self.cfg.seed * 1_000_003 + step * 8191 + host * 131) % (2**31 - 1)
        return np.random.RandomState(mix)

    def host_batch(self, step: int, host: int) -> dict[str, np.ndarray]:
        """-> {"tokens": (per_host, S), "labels": (per_host, S)} int32."""
        c = self.cfg
        rng = self._host_rng(step, host)
        toks = rng.choice(c.vocab, size=(self.per_host, c.seq_len + 1),
                          p=self.probs).astype(np.int32)
        # plant motifs: ~25% of positions covered by repeated n-grams
        n_plant = (c.seq_len // c.motif_len) // 4
        for b in range(self.per_host):
            ids = rng.randint(0, c.motif_count, n_plant)
            pos = rng.randint(0, c.seq_len + 1 - c.motif_len, n_plant)
            for i, p0 in zip(ids, pos):
                toks[b, p0:p0 + c.motif_len] = self.motifs[i]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        parts = [self.host_batch(step, h) for h in range(self.cfg.n_hosts)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
