"""Where the harness finds each item, by the name `BENCHMARK.json` gives
it: a later cell, configuration, traffic mix, traffic kind or per-layer
metric is a new file (and an entry), never an edit.

- cells: the `workloads` entries of `BENCHMARK.json` at the checkout's root
- `configs/<config>.json`: one deployment (camera, `vo` table, source)
- `traffic/<traffic>.json`: one traffic mix's parameters; its `kind`
  names the driver `traffic/<kind>.py` (`run(system, pool, mix, seconds,
  tracer, on_warm)`)
- `metrics/<metric>.py`: the reader of one per-layer metric (`read(r)`)
- `roofline/<kernel>.py`: one hand-written kernel's bytes and operations
- `limits/<cell>.json`: the limit of each number that `correct` compares
- `pending/<cell>.json`: a cell kept out of `BENCHMARK.json` for now, its
  entries as they would stand there (`with_pending` adds them)
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits(cell_name: str, base: Path = HERE) -> dict:
    """{number: limit} of a cell."""
    return {k: v["limit"] for k, v in
            load_json(base / "limits" / f"{cell_name}.json").items()}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, base: Path = HERE):
    return _load(base / "traffic" / f"{kind}.py", f"vobench_traffic_{kind}")


def reader(metric: str, base: Path = HERE):
    return _load(base / "metrics" / f"{metric}.py",
                 "vobench_metric_" + metric.replace(".", "_"))


def roofline_modules(base: Path = HERE) -> list:
    return [_load(p, "vobench_roofline_" + p.stem)
            for p in sorted((base / "roofline").glob("*.py"))
            if p.stem != "__init__"]


def metrics_of(man: dict, cell_name: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that a cell reports: those
    whose `workloads` list it, and an end-to-end metric without that key
    in every cell."""
    e2e = [m for m in man["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    layer = [m for m in man["per_layer"] if cell_name in m["workloads"]]
    return e2e, layer


def with_pending(man: dict, cell_name: str, base: Path = HERE) -> dict:
    """`man` with a pending cell's entries added."""
    p = load_json(base / "pending" / f"{cell_name}.json")
    return dict(man, workloads=man["workloads"] + [p["workload"]],
                per_layer=man["per_layer"] + p["per_layer"])
