"""Where the benchmark's pieces live, found by name: a cell is
`workloads/<cell>.json`, its configuration `configs/<config>.json`, its
traffic driver `traffic/<kind>.py`, a per-layer metric's reader
`metrics/<metric>.py`. Adding a cell, a configuration, a traffic kind or a
metric adds files here and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """`BENCHMARK.json` at the repository root."""
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    why: str
    params: Dict[str, Any]
    limits: Dict[str, float]
    config: Dict[str, Any]  # the configuration file's contents


def cell_names() -> List[str]:
    d = os.path.join(HERE, "workloads")
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))


def load_cell(name: str) -> Cell:
    path = os.path.join(HERE, "workloads", name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no cell {name!r}: {path} is missing")
    w = load_json(path)
    cfg = load_json(os.path.join(HERE, "configs", w["config"] + ".json"))
    return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]), why=w["why"], params=w.get("params", {}),
                limits=w.get("limits", {}), config=cfg)


def load_module(kind: str, name: str):
    """`traffic/<name>.py` or `metrics/<name>.py` as a module (a metric's
    name may hold dots, so it is loaded from its path)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmarks.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, section: str) -> List[dict]:
    """The `section` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, and those without a `workloads` key."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def _build(cls, data: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue  # a field newer than the file keeps the program's default
        v = data[f.name]
        sub = _sub_dataclass(cls, f)
        if sub is not None:
            v = _build(sub, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        elif isinstance(v, str) and isinstance(f.default, float):
            v = float(v)
        kw[f.name] = v
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**kw)


def _sub_dataclass(cls, f):
    if f.default_factory is not dataclasses.MISSING:
        made = f.default_factory()
        if dataclasses.is_dataclass(made):
            return type(made)
    return None


def slam_config(cell: Cell):
    """The cell's `SLAMConfig`, every field as its file writes it."""
    from sags_tpu_torch.core.config import SLAMConfig

    return _build(SLAMConfig, cell.config["slam"])
