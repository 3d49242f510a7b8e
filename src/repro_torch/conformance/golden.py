"""Golden-trace oracles — pinned-seed reference snapshots under tests/golden/.

The port of ``repro.conformance.golden``. The differential oracles catch a
runtime drifting from the reference; goldens catch the REFERENCE ITSELF
drifting (every runtime moving together). For a pinned seed set, the
reference outputs (labels, first-spike times, final membranes, steps) and
the board cost account (cycles, energy, events, stalls) are snapshotted,
with each seed's artifact and program fingerprints in a manifest;
``check()`` regenerates each case from its seed with the port and compares
array-for-array bit-exactly.

``check`` reads ``tests/golden/`` by default: those snapshots belong to the
JAX package (its ``--regen`` writes them), so a clean ``check`` is the port
reproducing JAX's reference bit for bit. The port's ``regen`` never writes
there on its own: it takes its directory as a required argument.

    PYTHONPATH=src python -m repro_torch.conformance.golden     # check
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.conformance.fuzz import fuzz_case
from repro_torch.core.lowering import lower
from repro_torch.core.runtimes import make_runtime

#: default seed set — disjoint from the bench fuzzer's seed base (1000+)
PINNED_SEEDS = tuple(range(8))

GOLDEN_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "tests", "golden"))

MANIFEST = "manifest.json"
FORMAT = 2


def golden_path(seed: int, dirpath: str = GOLDEN_DIR) -> str:
    return os.path.join(dirpath, f"conformance_seed{seed}.npz")


def compute_golden(seed: int, *, device: str | torch.device = "cuda"
                   ) -> tuple[dict[str, np.ndarray], str, str]:
    """Regenerate the golden arrays for one pinned seed on ``device``.
    Returns (arrays, artifact_fingerprint, program_fingerprint)."""
    case = fuzz_case(seed)
    prog_fp = lower(case.artifact, device=device, cache=False).fingerprint
    out = make_runtime(case.artifact, "reference",
                       device=device).forward(case.images)
    board = make_runtime(case.artifact, "board", device=device)
    board.forward(case.images)
    tr = board.last_trace
    arrays = {
        "times": np.asarray(case.times, np.int32),
        "labels": out.labels.cpu().numpy().astype(np.int32),
        "first_spike": out.first_spike.cpu().numpy().astype(np.int32),
        "v_final": out.v_final.cpu().numpy().astype(np.int32),
        "steps": out.steps.cpu().numpy().astype(np.int32),
        "board_cycles": np.asarray(tr.cycles, np.int64),
        "board_events": np.asarray(tr.events, np.int64),
        "board_stalls": np.asarray(tr.stalls, np.int64),
        "board_energy_nj": np.asarray(tr.energy_nj, np.float64),
    }
    return arrays, case.artifact.fingerprint(), prog_fp


def regen(dirpath: str, seeds=PINNED_SEEDS, *,
          device: str | torch.device = "cuda") -> dict:
    """(Re)write golden snapshots + manifest into ``dirpath``. Returns the
    manifest."""
    os.makedirs(dirpath, exist_ok=True)
    manifest = {"format": FORMAT, "seeds": list(seeds), "fingerprints": {},
                "program_fingerprints": {}}
    for seed in seeds:
        arrays, fp, prog_fp = compute_golden(seed, device=device)
        np.savez(golden_path(seed, dirpath), **arrays)
        manifest["fingerprints"][str(seed)] = fp
        manifest["program_fingerprints"][str(seed)] = prog_fp
    with open(os.path.join(dirpath, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


@dataclasses.dataclass
class GoldenDiff:
    seed: int
    array: str          # which golden array drifted (or "<missing>"/"<meta>")
    detail: str

    def __str__(self) -> str:
        return f"seed {self.seed}: {self.array}: {self.detail}"


def check(seeds=None, dirpath: str = GOLDEN_DIR, *,
          device: str | torch.device = "cuda") -> list[GoldenDiff]:
    """Regenerate every pinned seed in memory on ``device`` and compare
    bit-exactly against the snapshots in ``dirpath``. Returns a list of
    diffs; empty means no drift."""
    mpath = os.path.join(dirpath, MANIFEST)
    if not os.path.exists(mpath):
        return [GoldenDiff(-1, "<missing>",
                           f"no golden manifest at {mpath}")]
    with open(mpath) as f:
        manifest = json.load(f)
    if seeds is None:
        seeds = manifest["seeds"]
    diffs: list[GoldenDiff] = []
    for seed in seeds:
        path = golden_path(seed, dirpath)
        if not os.path.exists(path):
            diffs.append(GoldenDiff(seed, "<missing>",
                                    f"snapshot {path} not found"))
            continue
        arrays, fp, prog_fp = compute_golden(seed, device=device)
        want_fp = manifest["fingerprints"].get(str(seed))
        if want_fp != fp:
            diffs.append(GoldenDiff(
                seed, "<meta>",
                f"artifact fingerprint {fp[:12]}… != manifest "
                f"{str(want_fp)[:12]}… — the fuzzer or artifact format "
                f"changed"))
        want_prog = manifest.get("program_fingerprints", {}).get(str(seed))
        if want_prog != prog_fp:
            diffs.append(GoldenDiff(
                seed, "<program>",
                f"program fingerprint {prog_fp[:12]}… != manifest "
                f"{str(want_prog)[:12]}… — lowering semantics changed"))
        with np.load(path) as z:
            stored = {k: z[k] for k in z.files}
        for name, fresh in arrays.items():
            if name not in stored:
                diffs.append(GoldenDiff(seed, name, "absent from snapshot"))
                continue
            old = stored[name]
            if old.shape != fresh.shape or old.dtype != fresh.dtype:
                diffs.append(GoldenDiff(
                    seed, name, f"shape/dtype drift: snapshot "
                    f"{old.dtype}{old.shape} vs fresh {fresh.dtype}{fresh.shape}"))
            elif not np.array_equal(old, fresh):
                n = int(np.sum(old != fresh))
                diffs.append(GoldenDiff(
                    seed, name, f"{n}/{fresh.size} elements drifted "
                    f"(e.g. snapshot {old.ravel()[np.argmax((old != fresh).ravel())]} "
                    f"vs fresh {fresh.ravel()[np.argmax((old != fresh).ravel())]})"))
        for name in stored:
            if name not in arrays:
                diffs.append(GoldenDiff(seed, name,
                                        "snapshot has an array check no "
                                        "longer computes"))
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regen", action="store_true",
                    help="write snapshots of the pinned seeds into --dir")
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="override the pinned seed set")
    ap.add_argument("--dir", default=None,
                    help="golden directory (check: default tests/golden/; "
                         "--regen: required)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    seeds = tuple(a.seeds) if a.seeds else PINNED_SEEDS
    if a.regen:
        if a.dir is None:
            ap.error("--regen needs --dir (tests/golden/ belongs to the JAX "
                     "package)")
        manifest = regen(a.dir, seeds, device=a.device)
        print(f"regenerated {len(manifest['seeds'])} golden snapshots "
              f"under {a.dir}")
        return 0
    diffs = check(None if a.seeds is None else seeds, a.dir or GOLDEN_DIR,
                  device=a.device)
    for d in diffs:
        print(f"GOLDEN DRIFT {d}")
    print(f"golden check: {'OK' if not diffs else f'{len(diffs)} drifts'}")
    return 1 if diffs else 0


if __name__ == "__main__":
    raise SystemExit(main())
