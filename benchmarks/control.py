"""The correctness check's readings on given seeds, in one process: the numbers as the program gives them (the lower reading), with
the reference computed with TF32 in the program's place (the control), and
what a planted fault would read where the session can work that out from
its copies (`fault_readings`). The program's and the control's numbers go
through the harness's own verdict (`run.judge`) against the cell's limits:
the program has to come out correct, the control not.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 [--seconds 51]

Each seed's window lasts `run_seconds` unless `--seconds` says otherwise:
the stream's check follows steps at the map size the window leaves. Prints
one JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import run as bench_run  # noqa: E402
from benchmarks.harness import device as dev  # noqa: E402
from benchmarks.harness import spec  # noqa: E402


def readings(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    session = spec.load_module("traffic", cell.traffic).setup(cell, seed, device)
    res = session.window(seconds)
    session.after_window()
    session.release()
    prog_ok, prog = bench_run.judge(session.check(), cell.limits)
    ctl_ok, ctl = bench_run.judge(session.check(control=True), cell.limits)
    out = {"seed": seed, "attempted": res["attempted"],
           "program": {"correct": prog_ok, "checks": prog},
           "control": {"correct": ctl_ok, "checks": ctl}}
    if hasattr(session, "fault_readings"):
        out["faults"] = session.fault_readings()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev.require_cards(cell.chips)
    import torch

    for s in args.seeds.split(","):
        t = time.perf_counter()
        seconds = args.seconds or spec.benchmark()["run_seconds"]
        out = readings(cell, int(s), seconds, torch.device("cuda", 0))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
