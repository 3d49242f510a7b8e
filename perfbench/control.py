#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/control.py --workload qwen3-8b.prefill-2x4k \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 3
    python3 perfbench/control.py --workload mixtral-8x7b-16l.prefill-2x4k \
        --seeds 21,22,23 --fault route_third --seconds 3

For each seed: the cell's program is built and set up as a run builds it,
driven through a short window at the cell's own load, freed, and its
outputs judged as a run judges them (``run.verdict``: the lower
reading);
for each control seed the control (the reference in float8,
``compare.py``) is judged the same way on the same inputs (the upper
reading). With ``--fault`` the program runs with that fault of
``faults.py`` planted (an upper reading too). One JSON line a seed, each
verdict's ``correct`` beside its numbers, then the largest program reading
and the smallest control reading of each number. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path[0] = str(HERE.parent)
    sys.path.insert(1, str(HERE.parent / "src"))


def readings(cell, seconds: float, control: bool, fault: str = "") -> dict:
    """One seed's program numbers and verdict and, with ``control``, the
    control's; with ``fault``, the program's under that fault."""
    from perfbench import faults, run
    from perfbench.trace import Tracer
    with faults.plant(fault, cell.seed) if fault else contextlib.nullcontext():
        win, _, _ = run.drive(cell, seconds, time.perf_counter(),
                              Tracer(False, cuda=cell.device != "cpu"))
        got = cell.driver.check(cell, win)
    out = {"seed": cell.seed, "attempted": win["attempted"],
           "correct": run.verdict(cell, got, win["failed"])[0],
           "program": got}
    if control:
        got = cell.driver.check(cell, win, control=True)
        out["control_correct"] = run.verdict(cell, got, win["failed"])[0]
        out["control"] = got
    return out


def main(argv=None) -> int:
    from perfbench import faults, run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="", choices=("",) + faults.FAULTS)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for s in (int(s) for s in args.seeds.split(",")):
        cell = run.load_cell(bench, args.workload, seed=s, trace=False,
                             device="cuda")
        t = time.perf_counter()
        rows.append(readings(cell, args.seconds, s in ctl, args.fault))
        rows[-1]["s"] = time.perf_counter() - t
        print(json.dumps(rows[-1]), flush=True)
    lower = {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}
    upper = {k: min(r["control"][k] for r in rows if "control" in r)
             for k in rows[0]["program"]} if ctl else {}
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "lower": lower, "upper": upper, "card": run.card_line(),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
