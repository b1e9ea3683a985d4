"""Run one cell of the benchmark of `sags_tpu_torch` once, on the CUDA
card this process finds:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number the correctness check compared with its
limit. The same numbers end standard error. A run that finds no CUDA card,
fewer cards than the cell asks for, or JAX or the JAX package loaded,
exits with another code than 0 and prints no result.
"""

import os
import time

T0 = time.perf_counter()  # set-up is measured from here
# one process, few threads: the host dispatches the card's work, and idle
# OpenMP and BLAS pools spinning on the machine's few cores make it jitter
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks.harness import device as dev  # noqa: E402
from benchmarks.harness import spec, trace  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def _guard(where: str) -> None:
    bad = dev.forbidden_modules()
    if bad:
        raise SystemExit(_fail(f"{where}: JAX or the JAX package is loaded: {bad}"))


def per_layer(bench: dict, cell: str, rec: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in spec.metrics_of(bench, cell, "per_layer"):
        v = spec.load_module("metrics", m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(checks: dict, limits: dict):
    """(correct, {name: {value, limit}}): every number within its limit. A
    number that could not be read (None, or not finite: printed as null)
    or has no limit is not correct."""
    table = {k: {"value": v if v is not None and math.isfinite(v) else None,
                 "limit": limits.get(k)} for k, v in checks.items()}
    ok = all(t["limit"] is not None and t["value"] is not None and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> dict:
    """One run of `cell` on `device` (set-up counted from `t0`): the
    result line's object, `checks` last."""
    bench = spec.benchmark()
    traffic = spec.load_module("traffic", cell.traffic)
    _guard("after loading the traffic driver and the reference")
    session = traffic.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    rec = session.stretches(int(cell.params["stretch_units"])) if traced else None
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's passes in the window
    res = session.window(seconds)
    trace.sync(device)
    record = dev.record(cell.chips) if device.type == "cuda" else {"platform": device.type}
    session.after_window()  # what the check compares, once the peak is read
    session.release()
    correct, checks = judge(session.check(), cell.limits)
    _guard("after the window")
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    if traced:
        out["metrics"] = per_layer(bench, cell.name, rec)
        a = rec["profiled"]
        record.update(busy_s=trace.busy_s(a.ops), window_s=a.wall_s)
        out["device"] = record
        out["breakdown"] = {"device_ops": trace.top_ops(a.ops),
                            "idle_gaps": trace.idle_gaps(a.ops, a.ranges)}
    else:
        units = {m["name"]: m["unit"] for m in spec.metrics_of(bench, cell.name, "end_to_end")}
        vals = dict(res["metrics"], setup_s=setup_s)
        out["metrics"] = {k: {"value": vals[k], "unit": u} for k, u in units.items()}
        out["device"] = record
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    cache = os.path.join(ROOT, "build", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    try:
        dev.require_cards(cell.chips)
    except RuntimeError as e:
        return _fail(str(e))
    import torch

    torch.set_num_threads(1)
    out = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    for k, t in out["checks"].items():
        print(f"check {k} {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
