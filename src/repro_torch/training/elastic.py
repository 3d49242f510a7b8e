"""Elastic scaling + straggler mitigation primitives (pure, unit-tested) —
the port's own copy of ``repro.training.elastic``, which imports nothing of
JAX: the port keeps its own.

At 1000+-node scale the failure model is: hosts drop out, re-join, or run
slow. The policy layer here is deliberately deterministic so every surviving
host computes the SAME new assignment with no coordinator:

  * ``shard_assignment``: data shards -> hosts, rendezvous-hash style;
  * ``rebalance``: minimal-movement reassignment after a failure (only the
    failed host's shards move);
  * ``StragglerMonitor``: flags hosts whose step time exceeds k x median over
    a sliding window; the training loop responds by shrinking that host's
    microbatch share (work stealing) or triggering rebalance;
  * the TokenPipeline (``repro_torch.data.tokens``) being a pure function of
    (seed, step, host) is what makes all of this recoverable: any host can
    recompute any shard of any step.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Sequence


def _score(shard: int, host: str) -> int:
    h = hashlib.sha256(f"{shard}:{host}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def shard_assignment(hosts: Sequence[str], n_shards: int) -> dict[int, str]:
    """Rendezvous hashing: shard -> argmax_host score(shard, host).
    Deterministic, coordinator-free, minimal movement under host churn."""
    assert hosts, "no live hosts"
    return {s: max(hosts, key=lambda h: _score(s, h)) for s in range(n_shards)}


def rebalance(assignment: dict[int, str], live_hosts: Sequence[str]
              ) -> tuple[dict[int, str], list[int]]:
    """Reassign only shards whose host died. Returns (new_assignment,
    moved_shards)."""
    live = set(live_hosts)
    moved = []
    new = {}
    for s, h in assignment.items():
        if h in live:
            new[s] = h
        else:
            new[s] = max(live_hosts, key=lambda x: _score(s, x))
            moved.append(s)
    return new, sorted(moved)


class StragglerMonitor:
    def __init__(self, window: int = 20, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self.times: dict[str, collections.deque] = {}

    def record(self, host: str, step_time: float) -> None:
        self.times.setdefault(
            host, collections.deque(maxlen=self.window)).append(step_time)

    def _median(self, xs: list[float]) -> float:
        xs = sorted(xs)
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def stragglers(self) -> list[str]:
        per_host = {h: self._median(list(t)) for h, t in self.times.items() if t}
        if len(per_host) < 2:
            return []
        med = self._median(list(per_host.values()))
        if med <= 0:
            return []
        return sorted(h for h, t in per_host.items()
                      if t > self.threshold * med)

    def work_shares(self, hosts: Sequence[str]) -> dict[str, float]:
        """Inverse-speed work split (straggler gets proportionally less)."""
        med = {h: self._median(list(self.times.get(h, [1.0])) or [1.0])
               for h in hosts}
        inv = {h: 1.0 / max(t, 1e-9) for h, t in med.items()}
        z = sum(inv.values())
        return {h: v / z for h, v in inv.items()}
