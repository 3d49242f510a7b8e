#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print its result.

    python3 perfbench/run.py --workload qwen3-8b.prefill-2x4k --seed 7 \
        --seconds 30 --trace 0

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``perfbench/configs/<config>.json``), its traffic
(``perfbench/traffic/<traffic>.json``, whose ``driver`` names
``perfbench/traffic/<driver>.py``), the numbers its comparison holds and
their limits (``perfbench/workloads/<cell>.json``) and one reader per per-layer metric
(``perfbench/metrics/<metric>.py``, ``read(ctx)``, None where it finds
nothing to read). Adding a cell, a configuration or a metric adds files.

A run: the port's ``LM`` built on the card with weights drawn from the
seed, the driver's set-up (its shapes warmed), the measured window of
``--seconds`` (with ``--trace 1``, then a fixed stretch of the same
traffic under ``torch.profiler``), the peak memory read, the program
freed, then the comparison with the plain reference. The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error. Without a card, or with fewer than the cell asks
for, it prints no result and exits 2; with ``jax``, ``jaxlib``, ``flax``
or ``repro`` loaded once the window has closed, 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    # perfbench's own directory would shadow the standard library's trace
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: every build and kernel cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    driver: object
    chips: int
    end_to_end: list
    per_layer: list
    seed: int
    trace: bool
    device: str

    @property
    def dtype(self):
        from perfbench.model import DTYPES
        return DTYPES[self.config["torch_dtype"]]

    def sync(self) -> None:
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()


def load_module(path: Path, prefix: str):
    name = prefix + "".join(ch if ch.isalnum() else "_" for ch in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, name: str, *, seed: int, trace: bool, device: str,
              root: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``), its files read
    from under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((root / "workloads" / f"{name}.json")
                        .read_text())["limits"]
    driver = load_module(root / "traffic" / f"{traffic['driver']}.py",
                         "perfbench_traffic_")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, config, traffic, limits, driver, w["chips"], e2e,
                per_layer, seed, trace, device)


def read_per_layer(cell: Cell, win: dict, summary: dict | None,
                   root: Path = HERE) -> dict:
    """Each per-layer metric's reader on the window's counters and the
    traced stretch; a reader that finds nothing leaves its metric out."""
    from perfbench import counts
    ctx = argparse.Namespace(config=cell.config, traffic=cell.traffic,
                             window=win["counters"], trace=summary,
                             counts=counts)
    out = {}
    for m in cell.per_layer:
        reader = load_module(root / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def drive(cell: Cell, seconds: float, t0: float, tracer):
    """Build the program, set it up, run the window (and the traced
    stretch), read the peak memory and free the program -> (the window's
    record, setup_s, peak bytes)."""
    import torch
    from perfbench import model
    marks = [("imports", time.perf_counter())]
    lm = model.build(cell.config, cell.seed, cell.device)
    cell.sync()
    marks.append(("weights", time.perf_counter()))
    state = cell.driver.setup(cell, lm)
    del lm
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("perfbench: set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for name, (_, a), (_, b)
        in zip([m[0] for m in marks], [("", t0)] + marks, marks)),
        file=sys.stderr)
    win = cell.driver.window(cell, state, seconds, tracer)
    tracer.stop()
    cuda = cell.device != "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return win, setup_s, peak


def verdict(cell: Cell, numbers: dict, failed: int):
    """-> (correct, compared): whether ``numbers`` (``driver.check``'s) meet
    every limit of the cell with no call failed, and the numbers compared
    with their limits."""
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in cell.limits.items()}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    return correct, compared


def run_cell(cell: Cell, seconds: float, t0: float, root: Path = HERE,
             control: bool = False):
    """One run of ``cell`` -> (result, compared): the result line's object
    without its ``compared`` key, and the numbers compared with their
    limits (with ``control``, the control's)."""
    import torch
    from perfbench.trace import Tracer
    cuda = cell.device != "cpu"
    tracer = Tracer(cell.trace, cuda=cuda)
    win, setup_s, peak = drive(cell, seconds, t0, tracer)
    correct, compared = verdict(
        cell, cell.driver.check(cell, win, control=control), win["failed"])
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"]}
    if cell.trace:
        s = tracer.summary()
        result["metrics"] = read_per_layer(cell, win, s, root)
        if s is not None:
            device.update(busy_s=s["busy_s"], window_s=s["window_s"])
            result["breakdown"] = {"device_ops": s["device_ops"],
                                   "idle_gaps": s["idle_gaps"]}
    else:
        result["metrics"] = {}
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" \
                else win["end_to_end"][m["name"]]
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
    result["device"] = device
    return result, compared


def forbidden_modules() -> list[str]:
    """Top-level names of the loaded modules that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control in the program's place: the "
                    "result must read correct false")
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "perfbench"
    for var, sub in CACHES.items():
        os.environ[var] = str(cache / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(bench, args.workload, seed=args.seed,
                     trace=bool(args.trace), device="cuda")
    t_imports = time.perf_counter()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"perfbench: harness and torch imported in {t_imports - T0:.3f} s, "
          f"CUDA found in {time.perf_counter() - t_imports:.3f} s",
          file=sys.stderr)
    result, compared = run_cell(cell, args.seconds, T0,
                                control=bool(args.control))
    print(f"perfbench: {cell.name} seed {args.seed} on {card_line()}, torch "
          f"{torch.__version__}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["compared"] = compared
    for k, c in compared.items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
