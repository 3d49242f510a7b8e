"""The paper's own deployed workload: 784-to-150 TTFS classifier, 10 class
groups x 15 neurons, T=32, int8 weights + int32 thresholds. Not an
ArchConfig — the SNN family has its own core runtime (repro_torch.core)."""
SNN_CONFIG = {
    "n_in": 784, "n_out": 150,
    "n_groups": 10, "per_group": 15,
    "T": 32, "leak_tau": 16.0,
    "fallback": "membrane",
}
